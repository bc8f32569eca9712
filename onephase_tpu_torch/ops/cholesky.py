"""Batched Cholesky + explicit-inverse solve operator M = L^-T L^-1.

The factorization is 35% of the reference's runtime and each factor feeds
~10 backsolves (docs/one-phase.tex:901-912).  As in the JAX package, the
`pallas` and `invchol` lanes turn an accepted factor into the explicit
inverse M, so every backsolve is one batched matvec.

Kernel wrappers of the `pallas` lane (CUDA tensors -> CUDA C++ kernel, CPU
tensors -> the plain version):

- `pallas_chol`: replaces onephase_tpu/ops/cholesky.py:pallas_chol
  (`_chol_kernel`, `_unblocked_chol`, `_tri_inv_unblocked`) with
  `csrc/chol.cu`.  Q (B, n, n) -> (L, d, ok).
- `pallas_tri_inv_gram`: replaces onephase_tpu/ops/cholesky.py:
  pallas_tri_inv_gram (`_tri_inv_gram_kernel`) with `csrc/tri_inv.cu`
  (the columns of L^-1) followed by the Gram product over the lower tile
  pairs, the kernel of `csrc/fused_q.cu` in its lower-triangular mode.
  L (B, n, n) -> M (B, n, n), symmetric bit for bit.
- `pallas_chol_inv`: the two in sequence (the JAX package's
  pallas_chol_inv).

Plain PyTorch versions: `xla_chol` (cholesky_ex + diag + ok),
`blocked_tri_inv` and `xla_chol_inv_from_L`.  The `xla`/`invchol` lanes
use these library ops, as the JAX package leaves those lanes to XLA.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from . import _build
from .schur import launch_fused_q

_FLOATS = (torch.float32, torch.float64)


def xla_chol(Q):
    """(L, d, ok) by `torch.linalg.cholesky_ex`: ok (B,) bool is True where
    every pivot was positive (LAPACK's info == 0)."""
    L, info = torch.linalg.cholesky_ex(Q)
    return L, torch.diagonal(L, dim1=-2, dim2=-1), info == 0


def _check_square(t, name):
    if t.dim() != 3 or t.shape[-1] != t.shape[-2]:
        raise ValueError(f"{name}: expected a (B, n, n) batch, got "
                         f"{tuple(t.shape)}")
    if t.dtype not in _FLOATS:
        raise TypeError(f"{name}: dtype {t.dtype} is not float32/float64")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name}: a CUDA input must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")


def pallas_chol(Q):
    """Batched Cholesky (L, d, ok): L lower with the strict upper triangle
    zeroed, d = diag(L), ok (B,) bool = every pivot positive and finite.
    On failure L is garbage and only ok matters."""
    _check_square(Q, "chol")
    if Q.device.type == "cpu":
        return xla_chol(Q)
    B, n = Q.shape[0], Q.shape[-1]
    L = torch.empty_like(Q)
    d = torch.empty(B, n, dtype=Q.dtype, device=Q.device)
    ok = torch.empty(B, dtype=torch.int32, device=Q.device)
    if B > 0 and n > 0:
        with torch.cuda.device(Q.device):
            err = _build.entry("op_chol", Q.dtype)(
                Q.data_ptr(), L.data_ptr(), d.data_ptr(), ok.data_ptr(),
                B, n, _build.stream_ptr(Q))
        _build.check(err, "chol")
        LAUNCHES["chol"] += 1
    else:
        ok.fill_(1)
    return L, d, ok != 0


def blocked_tri_inv(L, block: int = 256):
    """L^-1 for a batch of lower-triangular L: invert the diagonal blocks
    (one batched triangular solve), then fill the strictly-lower block
    columns left to right with matmuls (port of the JAX package's
    blocked_tri_inv; same O(n^3/3) flops as solve_triangular(L, I))."""
    n = L.shape[-1]
    eye = torch.eye(n if n <= block else block, dtype=L.dtype,
                    device=L.device)
    if n <= block:
        return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    nb = -(-n // block)
    n_p = nb * block
    if n_p != n:
        Lp = torch.zeros(L.shape[:-2] + (n_p, n_p), dtype=L.dtype,
                         device=L.device)
        Lp[..., :n, :n] = L
        idx = torch.arange(n, n_p, device=L.device)
        Lp[..., idx, idx] = 1.0
        L = Lp
    diag = torch.stack([L[..., j * block:(j + 1) * block,
                          j * block:(j + 1) * block] for j in range(nb)],
                       dim=-3)
    dinv = torch.linalg.solve_triangular(diag, eye.expand_as(diag),
                                         upper=False)
    X = torch.zeros_like(L)
    for j in range(nb):
        X[..., j * block:(j + 1) * block,
          j * block:(j + 1) * block] = dinv[..., j, :, :]
    # left-looking fill: X[i,j] = -Dinv[i] @ L[i, j..i-1] @ X[j..i-1, j]
    for j in range(nb):
        c0, c1 = j * block, (j + 1) * block
        for i in range(j + 1, nb):
            r0, r1 = i * block, (i + 1) * block
            S = L[..., r0:r1, c0:r0] @ X[..., c0:r0, c0:c1]
            X[..., r0:r1, c0:c1] = -(dinv[..., i, :, :] @ S)
    return X[..., :n, :n] if n_p != n else X


def xla_chol_inv_from_L(L):
    """M = L^-T L^-1 via blocked triangular inversion + a Gram matmul."""
    Li = blocked_tri_inv(L)
    return Li.transpose(-1, -2) @ Li


def launch_tri_inv(L, Li):
    """Launch `csrc/tri_inv.cu`: Li = L^-1 for validated CUDA tensors."""
    with torch.cuda.device(L.device):
        err = _build.entry("op_tri_inv", L.dtype)(
            L.data_ptr(), Li.data_ptr(), L.shape[0], L.shape[-1],
            _build.stream_ptr(L))
    _build.check(err, "tri_inv")


def pallas_tri_inv_gram(L):
    """M = (L L^T)^-1 = L^-T L^-1 for a batch of lower-triangular L (the
    strict upper triangle must be zero, as `pallas_chol` leaves it)."""
    _check_square(L, "tri_inv_gram")
    if L.device.type == "cpu":
        return xla_chol_inv_from_L(L)
    B, n = L.shape[0], L.shape[-1]
    Li = torch.empty_like(L)
    M = torch.empty_like(L)
    if B == 0 or n == 0:
        return M
    launch_tri_inv(L, Li)
    launch_fused_q(Li, None, None, None, M, lower=True)
    LAUNCHES["tri_inv_gram"] += 1
    return M


def pallas_chol_inv(Q):
    """(M, d, ok): explicit inverse of SPD Q plus the Cholesky pivot info."""
    L, d, ok = pallas_chol(Q)
    return pallas_tri_inv_gram(L), d, ok
