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
The JAX module's `sharded_arrow_factor_solve` (scenarios over a device
mesh) is not ported.
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


def arrow_factor(Qzz, Qkk, Bk, delta, use_pallas=False) -> ArrowFactor:
    """Qzz (B, nz, nz); Qkk (B, K, nx, nx); Bk (B, K, nx, nz); delta (B,)."""
    B, K, nx = Qkk.shape[:3]
    Lk, oks = _chol_ok(_shift(Qkk, delta).reshape(B * K, nx, nx),
                       use_pallas)
    Lk = Lk.reshape(B, K, nx, nx)
    # Z = L_k^-1 B_k, so B_k^T Q_kk^-1 B_k = Z^T Z
    Z = _lo(Lk, Bk)
    S = _shift(Qzz, delta) - (Z.transpose(-1, -2) @ Z).sum(1)
    LS, okS = _chol_ok(S, use_pallas)
    return ArrowFactor(Lk=Lk, LS=LS, ok=oks.reshape(B, K).all(-1) & okS)


def arrow_solve(f: ArrowFactor, Bk, rz, rk):
    """Solve the arrow system for (dz (B, nz), dxk (B, K, nx)) given rz
    (B, nz) and rk (B, K, nx)."""
    u = _lo(f.Lk, rk.unsqueeze(-1))                       # (B, K, nx, 1)
    border = _lo(f.Lk, Bk).transpose(-1, -2) @ u          # (B, K, nz, 1)
    rhs_z = rz - border.squeeze(-1).sum(1)
    t = _lo(f.LS, rhs_z.unsqueeze(-1))
    dz = torch.linalg.solve_triangular(f.LS.transpose(-1, -2), t,
                                       upper=True)        # (B, nz, 1)
    v = u - _lo(f.Lk, Bk @ dz.unsqueeze(1))
    dxk = torch.linalg.solve_triangular(f.Lk.transpose(-1, -2), v,
                                        upper=True)
    return dz.squeeze(-1), dxk.squeeze(-1)
