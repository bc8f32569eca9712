"""Dense symmetric-indefinite LDL^T with inertia, and the spectral backend,
over a leading batch axis.

Port of onephase_tpu/ops/ldlt.py.  The symmetric and clever-symmetric KKT
paths factor the quasi-definite augmented matrix [[H + delta I, J^T],
[J, -S/Y]] in the natural order (no pivoting, Vanderbei 1995); the
inertia is read off D's signs as the reference does (julia.jl:70-90).

- `ldlt`: the unpivoted right-looking recursion, one column a step.
  `torch.linalg.ldl_factor` pivots (Bunch-Kaufman): its D does not carry
  the unpivoted inertia `inertia_status` counts, so it is not this
  function.  Each step updates only the trailing block: the JAX package
  subtracts a masked outer product from the whole matrix, whose masked
  terms are exact zeros on finite input, so the values are the same at a
  third of the bytes.
- `eigh_inertia` / `eigh_solve`: `torch.linalg.eigh` (eigenvalues in
  ascending order, as `jnp.linalg.eigh`), kkt.linear_solver_type="eigh".

None of these is a TPU kernel in the JAX package (a `lax.fori_loop` and
XLA's `eigh`), so they stay plain PyTorch here.
"""

from __future__ import annotations

import torch

# reference tol for counting D's signs (julia.jl:74)
DIAG_TOL = 1e-20


def ldlt(K):
    """K (B, N, N) -> (L, d): unit-lower L (B, N, N) and d (B, N) with
    K = L diag(d) L^T, no pivoting.  A zero pivot is divided as 1 and
    non-finite entries reach d, where the inertia check rejects them."""
    A = K.clone(memory_format=torch.contiguous_format)
    N = A.shape[-1]
    for j in range(N - 1):
        dj = A[:, j, j]
        dj_safe = torch.where(dj == 0.0, torch.ones_like(dj), dj)
        col = A[:, j + 1:, j] / dj_safe[:, None]
        # one fused multiply-add a entry, as XLA contracts the reference's
        # A - outer(col, row): a late pivot of an ill-conditioned K is a
        # difference of large terms, and the rounding decides its digits
        A[:, j + 1:, j + 1:].addcmul_(col[:, :, None], A[:, j, None, j + 1:],
                                      value=-1.0)
        A[:, j + 1:, j] = col
    d = torch.diagonal(A, dim1=-2, dim2=-1).clone()
    L = torch.tril(A, -1)
    L.diagonal(dim1=-2, dim2=-1).fill_(1.0)
    return L, d


def ldlt_solve(L, d, b):
    """x (B, N) with L diag(d) L^T x = b; a zero d is divided as 1."""
    z = torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=False,
                                      unitriangular=True)
    d_safe = torch.where(d == 0.0, torch.ones_like(d), d)
    z = z / d_safe.unsqueeze(-1)
    return torch.linalg.solve_triangular(
        L.transpose(-1, -2), z, upper=True,
        unitriangular=True).squeeze(-1)


def inertia_status(d, n, m):
    """(B,) bool: reference inertia_status (linear_system_solvers.jl:
    48-91), correct iff n pivots are positive and m negative, none zero,
    NaN or inf."""
    finite = torch.isfinite(d).all(-1)
    pos = (d > DIAG_TOL).sum(-1)
    neg = (d < -DIAG_TOL).sum(-1)
    zer = d.shape[-1] - pos - neg
    return finite & (pos == n) & (neg == m) & (zer == 0)


def eigh_inertia(K):
    """Spectral factorization: (V, w) with K = V diag(w) V^T, w ascending."""
    w, V = torch.linalg.eigh(K)
    return V, w


def eigh_solve(V, w, b):
    """V diag(1/w) V^T b; a zero eigenvalue is divided as 1."""
    w_safe = torch.where(w == 0.0, torch.ones_like(w), w)
    c = torch.bmm(V.transpose(-1, -2), b.unsqueeze(-1)).squeeze(-1)
    return torch.bmm(V, (c / w_safe).unsqueeze(-1)).squeeze(-1)
