"""Example model families (port of onephase_tpu/models/examples.py): COPS
and Examples problems of the reference, and the structured problems of the
chain and scenario paths.

Reference counterparts:
- largest small polygon (benchmark/COPS/1-largest-small-polygon.jl:7-24)
- electrons on a sphere (benchmark/COPS/2-electron.jl:8-26)
- max-cut SDP-style relaxation (benchmark/Examples/max-cut.jl:4-22)
- kissing-number problems (benchmark/Examples/kissing.jl)
- chained Rosenbrock "CHAIN"-style smoke problem (test/CUTEst.jl:11-30)
- `two_stage_qp` (the scenario path, parallel/scenario.py) and `chain_ocp`
  (the chain path, parallel/chain.py)

The data comes from the same numpy `default_rng(seed)` draws in the same
order as the JAX package's, so the two packages solve the same problem bit
for bit.  Index arrays and data live on `device` (default: the CUDA card);
the functions are written for one instance (1-D z) and compute in the
dtype of the z they are given.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nlp import NLPSpec, resolve_device
from .qp import Data

INF = np.inf


def _idx(a, device):
    return torch.as_tensor(np.asarray(a), dtype=torch.long, device=device)


def largest_small_polygon(nv: int = 20, device=None) -> NLPSpec:
    """Max-area polygon of unit diameter, polar coordinates.

    Variables z = [theta(nv); r(nv)], theta in [0, pi], r in [0, 1];
    pairwise diameter constraints + theta ordering; r[nv-1] = 0,
    theta[nv-1] = pi fixed.
    """
    device = resolve_device(device)
    iu = np.triu_indices(nv, 1)
    iu_i, iu_j = _idx(iu[0], device), _idx(iu[1], device)

    def f(z):
        th, r = z[:nv], z[nv:]
        return -0.5 * torch.sum(r[1:] * r[:-1] * torch.sin(th[1:] - th[:-1]))

    def c(z):
        th, r = z[:nv], z[nv:]
        diam = (r[iu_i] ** 2 + r[iu_j] ** 2
                - 2.0 * r[iu_i] * r[iu_j] * torch.cos(th[iu_i] - th[iu_j]))
        order = th[1:] - th[:-1]
        return torch.cat([diam, order])

    m_d = len(iu[0])
    m_o = nv - 1
    lvar = np.concatenate([np.zeros(nv), np.zeros(nv)])
    uvar = np.concatenate([np.full(nv, np.pi), np.ones(nv)])
    lvar[2 * nv - 1] = uvar[2 * nv - 1] = 0.0       # r[nv-1] = 0
    lvar[nv - 1] = uvar[nv - 1] = np.pi             # theta[nv-1] = pi
    th0 = np.pi * (np.arange(nv) + 1.0) / nv
    x0 = np.concatenate([th0, np.full(nv, 0.5)])
    x0[2 * nv - 1] = 0.0
    return NLPSpec(
        f=f, c=c,
        lcon=np.concatenate([np.full(m_d, -INF), np.zeros(m_o)]),
        ucon=np.concatenate([np.ones(m_d), np.full(m_o, INF)]),
        lvar=lvar, uvar=uvar, x0=x0, name=f"polygon{nv}")


def electron(np_: int = 25, seed: int = 1, device=None) -> NLPSpec:
    """Min Coulomb potential of np_ electrons on the unit sphere."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(np_, 1)
    iu_i, iu_j = _idx(iu[0], device), _idx(iu[1], device)

    def f(z):
        pts = z.reshape(3, np_)
        d2 = torch.sum((pts[:, iu_i] - pts[:, iu_j]) ** 2, dim=0)
        return torch.sum(d2 ** -0.5)

    def c(z):
        pts = z.reshape(3, np_)
        return torch.sum(pts ** 2, dim=0)

    x0 = rng.random(3 * np_)
    return NLPSpec(f=f, c=c, lcon=np.ones(np_), ucon=np.ones(np_),
                   x0=x0, name=f"electron{np_}")


def max_cut(n: int = 50, r: int = 6, edge_density: float = 0.15,
            seed: int = 0, device=None) -> NLPSpec:
    """Low-rank max-cut relaxation: min sum_E <x_i, x_j>/2 - |E|/2
    s.t. ||x_i||^2 = 1."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    edges = []
    for i in range(n):
        for j in range(i + 1, n):
            if rng.random() < edge_density:
                edges.append((i, j))
    e_i = _idx([e[0] for e in edges], device)
    e_j = _idx([e[1] for e in edges], device)
    ne = len(edges)

    def f(z):
        X = z.reshape(n, r)
        return torch.sum(X[e_i] * X[e_j]) / 2.0 - ne / 2.0

    def c(z):
        X = z.reshape(n, r)
        return torch.sum(X ** 2, dim=1)

    x0 = rng.normal(size=n * r) / np.sqrt(r)
    return NLPSpec(f=f, c=c, lcon=np.ones(n), ucon=np.ones(n),
                   x0=x0, name=f"maxcut{n}x{r}")


def kissing(m_pts: int = 12, dim: int = 3, seed: int = 0,
            device=None) -> NLPSpec:
    """Kissing-number arrangement (KISSING2-style): place m points on the
    sphere of radius 2 maximizing the minimum pairwise distance >= 2."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(m_pts, 1)
    iu_i, iu_j = _idx(iu[0], device), _idx(iu[1], device)

    def f(z):
        return -z[-1]     # maximize slack t

    def c(z):
        pts = z[:-1].reshape(m_pts, dim)
        t = z[-1]
        norms = torch.sum(pts ** 2, dim=1)
        d2 = torch.sum((pts[iu_i] - pts[iu_j]) ** 2, dim=1)
        return torch.cat([norms, d2 - 4.0 * t])

    x0 = np.concatenate([rng.normal(size=m_pts * dim), [0.5]])
    npair = len(iu[0])
    return NLPSpec(
        f=f, c=c,
        lcon=np.concatenate([np.full(m_pts, 4.0), np.zeros(npair)]),
        ucon=np.concatenate([np.full(m_pts, 4.0), np.full(npair, INF)]),
        lvar=np.concatenate([np.full(m_pts * dim, -INF), [0.0]]),
        uvar=np.concatenate([np.full(m_pts * dim, INF), [1.5]]),
        x0=x0, name=f"kissing{m_pts}d{dim}")


def chain(n: int = 50, device=None) -> NLPSpec:
    """Chained-Rosenbrock with linear coupling constraints (CHAIN-style
    smoke problem, test/CUTEst.jl:11-30).  It holds no data; `device` is
    checked like every entry point's."""
    resolve_device(device)

    def f(z):
        return torch.sum(100.0 * (z[1:] - z[:-1] ** 2) ** 2
                         + (1.0 - z[:-1]) ** 2)

    def c(z):
        return z[:-1] + z[1:]

    return NLPSpec(f=f, c=c,
                   lcon=np.full(n - 1, -INF), ucon=np.full(n - 1, 4.0),
                   x0=np.full(n, -1.2), name=f"chain{n}")


def two_stage_qp(K: int = 4, nz: int = 3, nx: int = 4, mc: int = 2,
                 seed: int = 0, device=None):
    """Two-stage scenario QP for the arrow-KKT path (parallel/scenario.py):
    first-stage cost f0(z) + per-scenario recourse QPs with coupling
    constraints ck = Ak xk + Gk z - bk >= 0.  The scenario-structured
    analogue of the reference's ECON models (benchmark/Tax-problem).
    `mc` = per-scenario constraint count (<= nx keeps rows independent).
    The data lives on `device` (default: the CUDA card) in float32 and
    float64."""
    from ..parallel.scenario import TwoStageSpec

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    Ak = rng.normal(size=(K, mc, nx)) / np.sqrt(nx)
    Gk = rng.normal(size=(K, mc, nz)) * 0.5 / np.sqrt(nz)
    bk = rng.normal(size=(K, mc)) * 0.1
    Pk = rng.normal(size=(K, nx, nx))
    Pk = np.einsum("kij,klj->kil", Pk, Pk) / nx + np.eye(nx) * 0.5
    qk = rng.normal(size=(K, nx))

    data = {k: Data(v, device) for k, v in
            {"A": Ak, "G": Gk, "b": bk, "P": Pk, "q": qk}.items()}

    def f0(z):
        return 0.5 * torch.sum(z ** 2) + 0.1 * torch.sum(z)

    def fk(xk, z, d):
        return 0.5 * xk @ d["P"] @ xk + d["q"] @ xk + 0.2 * torch.dot(z, z)

    def ck(xk, z, d):
        return d["A"] @ xk + d["G"] @ z - d["b"]

    return TwoStageSpec(
        f0=f0, fk=fk, ck=ck, data=data, K=K, nz=nz, nx=nx, mc=mc,
        lcon=np.zeros(mc), ucon=np.full(mc, np.inf),
        lz=np.full(nz, -5.0), uz=np.full(nz, 5.0),
        lx=np.full(nx, -10.0), ux=np.full(nx, 10.0),
        z0=np.zeros(nz), x0=np.zeros(nx), name="two_stage_qp")


def chain_ocp(K: int = 16, nx: int = 8, mc: int = 4, seed: int = 0,
              device=None):
    """Stage-chained QP (multiple-shooting OCP shape) for the
    block-tridiagonal path (parallel/chain.py): per-stage tracking costs
    with cross terms and mc coupling constraints per adjacent pair -- the
    scalable analogue of the CHAIN smoke problem (reference
    test/CUTEst.jl:11-30).  The data lives on `device` (default: the CUDA
    card) in float32 and float64."""
    from ..parallel.chain import ChainSpec

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    Km = K - 1
    Pk = rng.normal(size=(Km, nx, nx))
    Pk = np.einsum("kij,klj->kil", Pk, Pk) / nx + np.eye(nx) * 0.5
    qk = rng.normal(size=(Km, nx)) * 0.3
    Ck = rng.normal(size=(Km, nx, nx)) * (0.3 / np.sqrt(nx))
    Ak = rng.normal(size=(Km, mc, nx)) / np.sqrt(nx)
    Dk = rng.normal(size=(Km, mc, nx)) / np.sqrt(nx)
    bk = rng.normal(size=(Km, mc)) * 0.1

    data = {k: Data(v, device) for k, v in
            {"P": Pk, "q": qk, "C": Ck, "A": Ak, "D": Dk, "b": bk}.items()}

    def fk(xa, xb, d):
        return (0.5 * xa @ d["P"] @ xa + d["q"] @ xa
                + xa @ d["C"] @ xb + 0.05 * torch.dot(xb, xb))

    def ck(xa, xb, d):
        return d["D"] @ xb - d["A"] @ xa - d["b"]

    return ChainSpec(
        fk=fk, ck=ck, data=data, K=K, nx=nx, mc=mc,
        lcon=np.zeros(mc), ucon=np.full(mc, np.inf),
        lx=np.full(nx, -10.0), ux=np.full(nx, 10.0),
        x0=np.zeros(nx), name=f"chain_ocp_K{K}_nx{nx}")
