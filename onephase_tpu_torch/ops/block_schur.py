"""Block-angular (arrow) KKT factorization for scenario-structured NLPs.

Port of onephase_tpu/ops/block_schur.py.  For two-stage / scenario
problems the primal Schur complement has arrow structure over (coupling z,
scenario blocks x_1..x_K):

    Q = [[Q_zz, B_1^T ... B_K^T],
         [B_1,  Q_11            ],
         [ ...,        ...      ],
         [B_K,             Q_KK ]]

factored by block elimination:

    L_k = chol(Q_kk + delta I)                          (every scenario)
    S   = Q_zz + delta I - sum_k B_k^T Q_kk^{-1} B_k    (the border)
    L_S = chol(S)

Inertia is correct iff every Cholesky succeeds (every pivot finite and
> 0): the Schur path's inertia rule lifted blockwise.

Batch-first: Qzz (B, nz, nz), Qkk (B, K, nx, nx), Bk (B, K, nx, nz), delta
(B,), ok (B,).  The two Cholesky factorizations take the lane's routine:
with `use_pallas` the hand kernel K2 (`ops/cholesky.pallas_chol`: one
launch over the (B K, nx, nx) scenario blocks and one over the (B, nz, nz)
border on the card, its plain version on the CPU), else
`torch.linalg.cholesky_ex` (`xla_chol`, the JAX package's
`jnp.linalg.cholesky`).  The triangular solves, the border sum and
`arrow_solve` are plain PyTorch, as they are XLA code in the JAX package.

Scenario sharding (`mesh`, parallel/mesh.py, axis "blk"): each rank passes
its own K/D scenarios' blocks (Qkk, Bk, rk) and the replicated border
(Qzz, rz).  The per-scenario border terms B_k^T Q_kk^-1 B_k and
B_k^T Q_kk^-1 r_k are gathered (Mesh.gather, exact) and summed on every
rank in the unsharded order, so the border factor and dz are the
unsharded ones bit for bit wherever the per-block products are; the
scenario factors and dxk stay on their rank.  `sharded_arrow_factor_solve`
is the JAX module's primitive of that name.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cholesky import pallas_chol, xla_chol


class ArrowFactor(NamedTuple):
    Lk: torch.Tensor    # (B, K, nx, nx) scenario Cholesky factors
    LS: torch.Tensor    # (B, nz, nz) border Cholesky factor
    ok: torch.Tensor    # (B,) bool


def _chol_ok(M, use_pallas):
    """(L, ok) of a (N, n, n) batch: ok (N,) = every pivot finite and > 0
    (a failed factorization is reported by the pivot flag, where the JAX
    package's Cholesky fills NaN)."""
    L, d, pok = (pallas_chol if use_pallas else xla_chol)(M.contiguous())
    return L, pok & torch.isfinite(d).all(-1) & (d > 0).all(-1)


def _shift(M, delta):
    """M + delta I for a batch M (B, ..., n, n) and delta (B,)."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return M + delta.to(M.dtype).reshape((-1,) + (1,) * (M.dim() - 1)) * eye


def _lo(L, R):
    return torch.linalg.solve_triangular(L, R, upper=False)


def _scenarios(mesh, local):
    """The (B, K, ...) stack of every rank's scenarios (identity without a
    mesh)."""
    return local if mesh is None else mesh.gather(local, 1)


def arrow_factor(Qzz, Qkk, Bk, delta, use_pallas=False,
                 mesh=None) -> ArrowFactor:
    """Qzz (B, nz, nz); Qkk (B, K, nx, nx); Bk (B, K, nx, nz); delta (B,).
    With a `mesh`, Qkk and Bk hold this rank's scenarios, and Lk is
    theirs; LS and ok are replicated."""
    B, K, nx = Qkk.shape[:3]
    Lk, oks = _chol_ok(_shift(Qkk, delta).reshape(B * K, nx, nx),
                       use_pallas)
    Lk = Lk.reshape(B, K, nx, nx)
    # Z = L_k^-1 B_k, so B_k^T Q_kk^-1 B_k = Z^T Z
    Z = _lo(Lk, Bk)
    ZtZ = _scenarios(mesh, Z.transpose(-1, -2) @ Z)
    S = _shift(Qzz, delta) - ZtZ.sum(1)
    LS, okS = _chol_ok(S, use_pallas)
    ok = _scenarios(mesh, oks.reshape(B, K)).all(-1) & okS
    return ArrowFactor(Lk=Lk, LS=LS, ok=ok)


def arrow_solve(f: ArrowFactor, Bk, rz, rk, mesh=None):
    """Solve the arrow system for (dz (B, nz), dxk (B, K, nx)) given rz
    (B, nz) and rk (B, K, nx).  With a `mesh` (the factor's), Bk and rk
    hold this rank's scenarios and dxk is theirs; dz is replicated."""
    u = _lo(f.Lk, rk.unsqueeze(-1))                       # (B, K, nx, 1)
    border = _lo(f.Lk, Bk).transpose(-1, -2) @ u          # (B, K, nz, 1)
    rhs_z = rz - _scenarios(mesh, border.squeeze(-1)).sum(1)
    t = _lo(f.LS, rhs_z.unsqueeze(-1))
    dz = torch.linalg.solve_triangular(f.LS.transpose(-1, -2), t,
                                       upper=True)        # (B, nz, 1)
    v = u - _lo(f.Lk, Bk @ dz.unsqueeze(1))
    dxk = torch.linalg.solve_triangular(f.Lk.transpose(-1, -2), v,
                                        upper=True)
    return dz.squeeze(-1), dxk.squeeze(-1)


def sharded_arrow_factor_solve(mesh, Qzz, Qkk, Bk, delta, rz, rk,
                               use_pallas=False):
    """Factor and solve with the scenarios sharded over `mesh`: every rank
    passes its K/D scenarios' Qkk (B, K/D, nx, nx), Bk (B, K/D, nx, nz)
    and rk (B, K/D, nx) and the replicated Qzz (B, nz, nz), rz (B, nz) and
    delta (a float or (B,)).  The border is assembled from the gathered
    per-scenario terms, factored and solved on every rank; the scenario
    back-solves stay local.  Returns (dz (B, nz), dxk (B, K/D, nx), ok
    (B,)), ok alike on every rank.  `use_pallas` factors the blocks and
    the border with K2 (ops/cholesky.pallas_chol)."""
    if not isinstance(delta, torch.Tensor):
        delta = torch.full((Qzz.shape[0],), float(delta), dtype=Qzz.dtype,
                           device=Qzz.device)
    f = arrow_factor(Qzz, Qkk, Bk, delta, use_pallas, mesh)
    dz, dxk = arrow_solve(f, Bk, rz, rk, mesh)
    return dz, dxk, f.ok
