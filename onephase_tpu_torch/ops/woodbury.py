"""Woodbury-identity solver and extreme-eigenvalue estimation.

Port of onephase_tpu/ops/woodbury.py (the reference's dormant helpers
src/helpers/woodbury.jl:3-77 and eigenvalues.jl:3-41), on one instance:
vectors are 1-D, matrices 2-D, and `solve_A` / `matvec` are functions of
a vector.  The Schur-dual LP path (ipm/dual.py) applies the same identity
with the normal matrix S explicit.
"""

from __future__ import annotations

import torch

from ..nlp import resolve_device


def woodbury_solve(solve_A, U, C, V, b, refine: int = 2, matvec_A=None):
    """Solve (A + U C V) x = b given x -> A^{-1} x.

    x = A^{-1} b - A^{-1} U (C^{-1} + V A^{-1} U)^{-1} V A^{-1} b, then
    `refine` passes of iterative refinement when `matvec_A` is given
    (woodbury.jl refines a fixed number of times the same way)."""
    Ainv_b = solve_A(b)
    Ainv_U = torch.stack([solve_A(U[:, i]) for i in range(U.shape[1])], 1)
    S = torch.linalg.inv(C) + V @ Ainv_U
    core = torch.linalg.solve(S, V @ Ainv_b)
    x = Ainv_b - Ainv_U @ core
    if matvec_A is not None:
        def full_mv(v):
            return matvec_A(v) + U @ (C @ (V @ v))
        for _ in range(refine):
            r = b - full_mv(x)
            Ainv_r = solve_A(r)
            core_r = torch.linalg.solve(S, V @ Ainv_r)
            x = x + (Ainv_r - Ainv_U @ core_r)
    return x


def min_eig_inverse_iteration(matvec, solve_shifted, n, shift=0.0,
                              iters: int = 30, generator=None,
                              dtype=torch.float64, device=None):
    """Estimate the minimum eigenvalue of a symmetric operator by inverse
    iteration on (A - shift I) (eigenvalues.jl:3-41).  The start vector
    is drawn from `generator` (a `torch.Generator`, whose device it takes;
    if None, a fresh one seeded 0 on `device`, by default the CUDA card).
    Returns (lambda, v)."""
    if generator is None:
        generator = torch.Generator(
            device=resolve_device(device)).manual_seed(0)
    v = torch.randn(n, generator=generator, dtype=dtype,
                    device=generator.device)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = solve_shifted(v)
        v = w / torch.linalg.vector_norm(w)
    lam = torch.dot(v, matvec(v))
    return lam, v
