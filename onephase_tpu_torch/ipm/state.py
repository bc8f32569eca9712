"""Solver state containers and status codes.

The JAX package threads an immutable pytree through `lax.while_loop`
(onephase_tpu/ipm/state.py).  The port keeps the same containers as
`NamedTuple`s of **batch-first** tensors: every leaf has a leading batch
axis B (a single solve is a batch of 1), scalars of the JAX state become
(B,) tensors.  Two exceptions keep memory flat across the batch:

- a folded constant (constant-structure Jacobian/Hessian) or the dense
  schur path's rebuilt-on-demand Q is carried as ``None`` (the JAX package
  carries a (0, 0) placeholder array);
- ``pdata`` is an empty dict (parametric problems are not ported yet).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# ---------------------------------------------------------------------------
# status codes (identical to onephase_tpu/ipm/state.py)
RUNNING = 0
OPTIMAL = 1                # :Optimal
PRIMAL_INFEASIBLE = 2      # :primal_infeasible
DUAL_INFEASIBLE = 3        # :dual_infeasible (unbounded)
MAX_GRADIENT = 4           # :max_gradient
MAX_IT = 5                 # :MAX_IT
MAX_TIME = 6               # :MAX_TIME
MAX_DELTA = 7              # :MAX_DELTA
NAN_ERR = 8                # :NaN_ERR
STALLED = 9                # per-instance no-progress exit (term.stall_patience)

STATUS_NAMES = {
    RUNNING: "RUNNING",
    OPTIMAL: "Optimal",
    PRIMAL_INFEASIBLE: "primal_infeasible",
    DUAL_INFEASIBLE: "dual_infeasible",
    MAX_GRADIENT: "max_gradient",
    MAX_IT: "MAX_IT",
    MAX_TIME: "MAX_TIME",
    MAX_DELTA: "MAX_DELTA",
    NAN_ERR: "NaN_ERR",
    STALLED: "STALLED",
}

# line-search / step statuses (internal)
LS_NONE = 0
LS_SUCCESS = 1
LS_PREDICT_RED_NON_NEG = 2
LS_MIN_ALPHA = 3
LS_MAX_LS_IT = 4
LS_S_BOUND = 5
LS_DUAL_INFEASIBLE = 6
LS_NAN_ERR = 7
LS_NOT_ENOUGH_PROGRESS = 8
LS_NAN_DIR = 9

Tensor = torch.Tensor


class Point(NamedTuple):
    """(x, y, s, mu, beta): x (B, n), y/s (B, m), mu/beta (B,)."""

    x: Tensor
    y: Tensor
    s: Tensor
    mu: Tensor
    beta: Tensor


class Cache(NamedTuple):
    """Oracle evaluations at the current (x, y)."""

    fval: Tensor     # (B,)
    cons: Tensor     # original c(x), (B, m_orig)
    a: Tensor        # canonical a(x), (B, m)
    g: Tensor        # grad f, (B, n)
    jt_y: Tensor     # (B, n)
    jt_ones: Tensor  # (B, n)


class Factor(NamedTuple):
    """KKT factorization state at the factorization point.

    Shapes of the dense schur path; N = n + mr on the symmetric paths
    (mr = m on `symmetric`, the number of row groups on
    `clever_symmetric`), where Q holds K and (L, D) the LDL^T pair or, under
    linear_solver_type="eigh", (V, w).  The structured kernels and the
    Schur-dual kernel hold tuples in the Jc, H, Q and L slots (see
    parallel/chain.py, parallel/banded.py and ipm/dual.py)."""

    Jc: Optional[Tensor]     # (B, m_orig, n); None when folded constant
    H: Optional[Tensor]      # (B, n, n); None when folded constant / zero
    Q: Optional[Tensor]      # (B, n, n) while forming; None when carried
    #                          on the schur path, K (B, N, N) when symmetric
    schur_diag: Tensor       # (B, n)
    L: Tensor                # (B, n, n): Cholesky factor or M = Q^-1
    D: Tensor                # (B, n): ones on the schur path
    delta: Tensor            # (B,)
    s_f: Tensor              # (B, m)
    y_f: Tensor              # (B, m)
    ok: Tensor               # (B,) bool
    # clever_symmetric under kkt_system_rescale: r (B, N), Q = R K R
    # with R = diag(r) (clever_symmetric.jl:310-338); None otherwise
    rescale: Optional[Tensor] = None


class Dir(NamedTuple):
    x: Tensor
    y: Tensor
    s: Tensor
    mu: Tensor
    beta: Tensor


class Filter(NamedTuple):
    merit: Tensor   # (B, cap)
    kkt: Tensor     # (B, cap)
    beta: Tensor    # (B, cap)
    count: Tensor   # (B,) int32


class History(NamedTuple):
    buf: Tensor     # (B, cap, NCOLS)
    count: Tensor   # (B,) int32


class LSInfo(NamedTuple):
    status: Tensor      # (B,) int32, LS_* code
    alpha_P: Tensor
    alpha_D: Tensor
    num_steps: Tensor   # (B,) int32


class State(NamedTuple):
    p: Point
    cache: Cache
    fact: Factor
    dir: Dir
    filt: Filter
    hist: History
    r0: Tensor
    delta: Tensor
    t: Tensor                  # (B,) int32 outer iteration counter
    status: Tensor             # (B,) int32
    step_ok: Tensor            # (B,) bool
    last_superlinear: Tensor   # (B,) bool
    kkt_ratio: Tensor
    eta: Tensor                # (B, 3)
    ls: LSInfo
    agg_mask: Tensor           # (B,) bool
    num_fac_inertia: Tensor    # (B,) int32
    tot_num_fac: Tensor        # (B,) int32
    cum_fac: Tensor            # (B,) int32
    bvals: dict                # bound values {l, u, lv, uv}, each (B, k)
    pdata: dict                # always {} in the port (parametric not ported)
    best_prog: Optional[Tensor] = None
    last_prog_t: Optional[Tensor] = None


def tree_select(mask: Tensor, new, old):
    """Per-instance select over matching state trees: instance b takes
    `new` where mask[b] else `old`.  The masked counterpart of a `lax.cond`
    / frozen `lax.while_loop` instance under `jax.vmap`."""
    if new is None or old is None:
        if new is not old:
            raise ValueError("tree_select: state trees differ in structure")
        return None
    if isinstance(new, Tensor):
        if new is old:
            return new
        m = mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim()))
        return torch.where(m, new, old)
    if isinstance(new, tuple):
        vals = [tree_select(mask, a, b) for a, b in zip(new, old)]
        return type(new)(*vals) if hasattr(new, "_fields") else tuple(vals)
    if isinstance(new, dict):
        return {k: tree_select(mask, new[k], old[k]) for k in new}
    raise TypeError(f"cannot select over {type(new).__name__}")
