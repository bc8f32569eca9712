"""Mirrlees optimal-tax design NLPs (the ECON50/125/250 problems), port of
onephase_tpu/models/tax.py.

Reference: benchmark/Tax-problem/tax1D.jl:6-36 -- `na` agent types with
utility u_i(c, y) = log(c) - (y/w_i)^(mu_i+1)/(mu_i+1); maximize total
welfare subject to incentive-compatibility constraints u_i(c_i,y_i) >=
u_i(c_p,y_p) for all i != p and a resource constraint sum lambda_i (y_i -
c_i) >= 0.  Baseline parity targets
(benchmark-tables/table_ECON_one-phase.csv:2-4): ECON50 268 it / ECON125
250 it / ECON250 326 it, all Optimal.

The na(na-1) incentive rows come from one (na, na) utility matrix.  The
wage data lives on `device` (default: the CUDA card) in float32 and
float64; the functions compute in the dtype of the z they are given.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nlp import NLPSpec, resolve_device
from .qp import Data

INF = np.inf

WAGE_SPREADS = ("additive", "banded")


def _offdiag(M, na):
    """Row-major off-diagonal elements of an (na, na) matrix by strided
    slices: flat[1:].reshape(na-1, na+1)[:, :-1] is exactly the
    nonzero(~eye) row-major order."""
    return M.reshape(-1)[1:].reshape(na - 1, na + 1)[:, :-1].reshape(-1)


def tax1d(na: int = 50, mu_exp: float = 1.0, lam: float = 1.0,
          device=None) -> NLPSpec:
    """ECON`na`: the dense one-dimensional Mirrlees model."""
    device = resolve_device(device)
    w = Data(np.linspace(1.0, float(na), na), device)    # wages 1..na
    mu1 = mu_exp + 1.0                                    # mu_i + 1

    def f(z):
        c, y = z[:na], z[na:]
        own = torch.log(c) - (y / w(z.dtype)) ** mu1 / mu1
        return -lam * torch.sum(own)

    def c_fn(z):
        c, y = z[:na], z[na:]
        # U[i, p] = u_i(c_p, y_p) = log(c_p) - (y_p / w_i)^(mu+1)/(mu+1)
        U = (torch.log(c)[None, :]
             - (y[None, :] / w(z.dtype)[:, None]) ** mu1 / mu1)
        own = torch.diagonal(U)
        ic = _offdiag(own[:, None] - U, na)     # u_i(own) - u_i(p's bundle)
        resource = lam * torch.sum(y - c)
        return torch.cat([ic, resource[None]])

    m = na * (na - 1) + 1
    return NLPSpec(
        f=f, c=c_fn,
        lcon=np.zeros(m), ucon=np.full(m, INF),
        lvar=np.zeros(2 * na), uvar=np.full(2 * na, INF),
        x0=np.ones(2 * na), name=f"ECON{na}")


def tax_grouped(G: int = 8, na_g: int = 16, mu_exp: float = 1.0,
                lam: float = 1.0, wage_spread: str = "additive",
                device=None):
    """Block-angular ECON variant for the arrow-KKT path
    (parallel/scenario.py): G agent groups (regions), each with its own
    wage grid and within-group incentive-compatibility rows, coupled
    through a shared demogrant z (a lump-sum transfer added to every
    agent's consumption, funded group by group).

    `wage_spread`: "additive" -- group g covers wages offset by g, so the
    relative within-group spread shrinks like 1/g and at large G the high
    groups' IC rows become near-parallel; "banded" -- group g reuses the
    wage band of g % 8, keeping every group at the small-G conditioning
    while the block count still scales with G.  Any other value raises
    (the JAX package falls through to "additive" there).
    """
    from ..parallel.scenario import TwoStageSpec

    if wage_spread not in WAGE_SPREADS:
        raise ValueError(f"wage_spread={wage_spread!r}: expected one of "
                         f"{WAGE_SPREADS}")
    device = resolve_device(device)
    mu1 = mu_exp + 1.0
    shift = (lambda g: g % 8) if wage_spread == "banded" else (lambda g: g)
    w = np.stack([np.linspace(1.0 + shift(g), float(na_g) + shift(g), na_g)
                  for g in range(G)])                   # (G, na_g)
    iu = np.nonzero(~np.eye(na_g, dtype=bool))
    iu_r = torch.as_tensor(iu[0], dtype=torch.long, device=device)
    iu_c = torch.as_tensor(iu[1], dtype=torch.long, device=device)
    data = {"w": Data(w, device)}
    mc = na_g * (na_g - 1) + 1

    def split(xk):
        return xk[:na_g], xk[na_g:]

    def fk(xk, z, d):
        c, y = split(xk)
        ce = c + z[0]
        own = torch.log(ce) - (y / d["w"]) ** mu1 / mu1
        return -lam * torch.sum(own)

    def f0(z):
        return 0.0 * z[0]

    def ck(xk, z, d):
        c, y = split(xk)
        ce = c + z[0]
        U = (torch.log(ce)[None, :]
             - (y[None, :] / d["w"][:, None]) ** mu1 / mu1)
        own = torch.diagonal(U)
        ic = own[iu_r] - U[iu_r, iu_c]
        resource = lam * torch.sum(y - c) - na_g * z[0]
        return torch.cat([ic, resource[None]])

    return TwoStageSpec(
        f0=f0, fk=fk, ck=ck, data=data, K=G, nz=1, nx=2 * na_g, mc=mc,
        lcon=np.zeros(mc), ucon=np.full(mc, np.inf),
        lz=np.zeros(1), uz=np.full(1, 10.0),
        lx=np.concatenate([np.full(na_g, 1e-6), np.zeros(na_g)]),
        ux=np.full(2 * na_g, np.inf),
        z0=np.full(1, 0.1), x0=np.ones(2 * na_g),
        name=f"ECON_G{G}x{na_g}")
