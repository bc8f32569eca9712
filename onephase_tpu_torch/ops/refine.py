"""Double-single (compensated) arithmetic for iterative-refinement residuals.

Port of onephase_tpu/ops/refine.py.  Plain f32 residuals stop
improving once eps*cond(Q) ~ 1; carrying residual matvecs as (hi, lo)
pairs, with every product split exactly (Dekker/Veltkamp), gives ~2x the
working precision from working-precision ops only.  Enabled with
`kkt.it_refine_highprec = True`.

`pair_matvec64` / `pair_matvec64_t` (`kkt.hi_matvec_f32pair`) run a
float64 matvec as float32 double-single pairs: each float64 operand is
split exactly into (hi, lo) float32 parts, the hi-hi products are
compensated, and the eps32-small cross term is a plain float32 product.

Every step is a separate PyTorch op: Veltkamp splitting is exact only if
each product is rounded before the following add, so nothing here may be
fused into an FMA (no `addcmul`, no `torch.compile`).
"""

from __future__ import annotations

import torch

from ..nlp import _mtv, _mv


def _split_const(dtype):
    # Veltkamp splitting constant: 2^ceil(p/2) + 1 (p = mantissa bits)
    return {torch.float32: 4097.0, torch.float64: 134217729.0}[dtype]


def two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def split(a):
    c = _split_const(a.dtype) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def ds_add(x_hi, x_lo, y_hi, y_lo):
    s, e = two_sum(x_hi, y_hi)
    e = e + x_lo + y_lo
    hi, lo = two_sum(s, e)
    return hi, lo


def ds_matvec(A, x_hi, x_lo=None):
    """(A @ x) as a double-single pair (hi, lo), batch-first: A shared
    (r, k) or batched (B, r, k), x (B, k) -> (B, r) pairs."""
    if x_lo is None:
        x_lo = torch.zeros_like(x_hi)
    P, E = two_prod(A, x_hi[:, None, :])
    E = E + A * x_lo[:, None, :]
    return _ds_tree_sum(P, E)


def _ds_tree_sum(P, E):
    """Compensated binary-tree reduction of (..., k) double-single pairs
    along the last axis: O(log k) levels of full-width ds_add."""
    n = P.shape[-1]
    if n == 0:
        z = P.new_zeros(P.shape[:-1])
        return z, z.clone()
    while n > 1:
        half = (n + 1) // 2
        if n % 2:
            pad = P.new_zeros(P.shape[:-1] + (1,))
            P = torch.cat([P[..., :n], pad], dim=-1)
            E = torch.cat([E[..., :n], pad], dim=-1)
            n = n + 1
        P, E = ds_add(P[..., 0:n:2], E[..., 0:n:2], P[..., 1:n:2],
                      E[..., 1:n:2])
        n = half
    return P[..., 0], E[..., 0]


def ds_axpy(alpha, x_hi, x_lo, y_hi, y_lo):
    """alpha*x + y in double-single (alpha a plain scalar)."""
    p, e = two_prod(torch.full_like(x_hi, alpha), x_hi)
    e = e + alpha * x_lo
    return ds_add(p, e, y_hi, y_lo)


def pair_split(A):
    """Exact float32 (hi, lo) pair of a float64 tensor."""
    hi = A.to(torch.float32)
    lo = (A - hi.to(A.dtype)).to(torch.float32)
    return hi, lo


def _pair_result(hi, lo, corr):
    hi, lo = ds_add(hi, lo, corr, torch.zeros_like(corr))
    return hi.to(torch.float64) + lo.to(torch.float64)


def pair_matvec64(A, x):
    """A @ x for float64 A, shared (r, k) or batched (B, r, k), and x
    (B, k) -> float64 (B, r), via float32 double-single (relative error
    ~1e-13)."""
    Ah, Al = pair_split(A)
    xh, xl = pair_split(x)
    hi, lo = ds_matvec(Ah, xh, xl)
    return _pair_result(hi, lo, _mv(Al, xh))


def pair_matvec64_t(A, w):
    """A^T @ w for float64 A, shared (r, k) or batched (B, r, k), and w
    (B, r) -> float64 (B, k), via float32 double-single."""
    Ah, Al = pair_split(A)
    wh, wl = pair_split(w)
    hi, lo = ds_matvec(Ah.transpose(-1, -2), wh, wl)
    return _pair_result(hi, lo, _mtv(Al, wh))
