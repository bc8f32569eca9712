"""One-phase IPM core on batch-first PyTorch tensors (dense Schur path).

Port of onephase_tpu/ipm/core.py.  The JAX package traces the algorithm
once and runs it under `jax.vmap`: every bounded `lax.while_loop` runs until
its slowest instance finishes with the finished ones frozen, and every
`lax.cond` becomes a select that evaluates both branches.  This port runs
eagerly with the batch axis written out and reproduces exactly those
semantics:

- a `lax.cond` is both branches plus `tree_select` on a per-instance mask;
- a bounded `lax.while_loop` is a Python loop whose carry is updated only
  where the instance is still active.

Host syncs: eager PyTorch has no device-side `while`, so each bounded inner
loop (δ search, step attempts, backtracking, adaptive refinement) reads
`bool(active.any())` once per trip, and the chunk loop reads the status
once per outer iteration.  Nothing else inside `_run_chunk` reads a device
value on the host.  `OnePhaseKernel.host_syncs` counts those reads.

KKT paths (`kkt.kkt_solver_type`):

- `schur` (default): the primal Schur complement, dense here,
  block-tridiagonal in the structured subclasses of parallel/chain.py and
  parallel/banded.py and arrow-shaped in parallel/scenario.py, whose
  Factor fields (Jc, H, Q, L) may be tuples of block tensors -- every
  select over the factor goes through `tree_select`.  The dense path runs
  the precision knobs of the JAX package (`kkt.factor_precision`,
  `fallback_form_f32`, `hi_matvec_f32pair`, `precond_f32`,
  `q_form_dtype`, `residual_precision`) and the Mehrotra init; the
  structured kernels take them as the JAX package's do
  (`check_structured`).
- `symmetric`: the augmented system K = [[H, J^T], [J, -S/Y]] (n + m
  square) by unpivoted LDL^T with D-sign inertia, or by `eigh` under
  `kkt.linear_solver_type="eigh"` (ops/ldlt.py).
- `clever_symmetric`: the same with parallel rows merged into one row per
  group (n + mr square), optionally rescaled (`kkt.kkt_system_rescale`).
- `schur_dual`: the dual normal matrix of LPs, a subclass in ipm/dual.py
  that `make_kernel` builds.

Parametric problems (`NLPSpec.pdata`): the batch's data rides in
`State.pdata` and every oracle call takes it, as in the JAX core.  With
`constant_jac` (or `constant_hess`) on a parametric problem the Jacobian
(Hessian) is evaluated once per solve, in the initial state, and carried in
`Factor.Jc` (`Factor.H`) per instance: a (B, m_orig, n) Jc, which the Q
kernel takes as it is.

Options outside the port (`matmul_precision` other than "highest"/
"default") raise `NotImplementedError` instead of quietly running the
default.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

from ..config import Params
from ..nlp import CanonNLP, _mtv, _mv
from ..ops import ldlt as ldlt_mod
from ..ops import refine as dsr
from ..ops.cholesky import (pallas_chol, pallas_tri_inv_gram, xla_chol,
                            xla_chol_inv_from_L)
from . import history as hist_mod
from .state import (Cache, Dir, Factor, Filter, History, LSInfo, Point, State,
                    DUAL_INFEASIBLE, LS_DUAL_INFEASIBLE, LS_MAX_LS_IT,
                    LS_MIN_ALPHA, LS_NAN_ERR, LS_NONE,
                    LS_NOT_ENOUGH_PROGRESS, LS_PREDICT_RED_NON_NEG, LS_S_BOUND,
                    LS_SUCCESS, MAX_DELTA, MAX_GRADIENT, MAX_IT, OPTIMAL,
                    PRIMAL_INFEASIBLE, RUNNING, STALLED, tree_select)

# step-type codes for history
STEP_IT0 = 0
STEP_AGG = 1
STEP_STB = 2

INT = torch.int32


def _norm_inf(v):
    """max |v| over the last axis; 0 for an empty axis."""
    if v.shape[-1] == 0:
        return v.new_zeros(v.shape[:-1])
    return v.abs().amax(-1)


def _norm1(v):
    return v.abs().sum(-1)


def _isbad(v):
    """Per instance: any non-finite entry along the last axis."""
    return ~torch.isfinite(v).all(-1)


def _c(v):
    """Per-instance scalar (B,) -> column (B, 1) for broadcasting."""
    return v[:, None]


def _factor_to(L, dtype):
    """A factor, or a structured kernel's tuple of factor blocks, in
    `dtype`."""
    if isinstance(L, tuple):
        return tuple(t.to(dtype) for t in L)
    return L.to(dtype)


@contextlib.contextmanager
def _mm_precision_ctx(name: str):
    """Matmul precision for the solver's entry points (Params.
    matmul_precision).  "highest" runs float32 CUDA matmuls in full
    float32 (no TF32), saved and restored around the call."""
    if name in (None, "", "default"):
        yield
        return
    if name != "highest":
        raise NotImplementedError(
            f"matmul_precision={name!r} is not ported to onephase_tpu_torch")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _option(pars: Params, key: str):
    group, name = key.split(".")
    return getattr(getattr(pars, group), name)


def check_structured(pars: Params, dtype):
    """A structured kernel's check of the precision knobs, as the JAX
    package's structured kernels behave (decided by running them): every
    knob runs (most are read only by the dense Schur path, and
    `residual_precision` and the Mehrotra init reach the structured paths
    through the base class), except `kkt.factor_precision="f32"` under a
    float64 solve, whose float32 stale factor the JAX delta search cannot
    select against the solve-dtype block factor (a TypeError in its
    `lax.cond`).  The banded kernel raises its own ValueError for any
    factor_precision but "same" instead."""
    if pars.kkt.factor_precision == "f32" and dtype == torch.float64:
        raise TypeError(
            "kkt.factor_precision='f32' carries a float32 factor, which a "
            "structured kernel's float64 block factor cannot replace (the "
            "JAX package's delta search raises the same TypeError)")


SYMMETRIC = ("symmetric", "clever_symmetric")


def _check_supported(pars: Params):
    kkt = pars.kkt
    if kkt.kkt_solver_type == "schur_dual":
        raise ValueError("kkt_solver_type='schur_dual' is the "
                         "SchurDualKernel of ipm/dual.py (make_kernel)")
    choices = {
        "kkt.kkt_solver_type": ("schur",) + SYMMETRIC,
        "kkt.factor_precision": ("same", "f32", "f32_fallback"),
        "kkt.hi_matvec_f32pair": ("off", "refine", "all"),
        "kkt.q_form_dtype": ("same", "bf16"),
        "kkt.residual_precision": ("same", "f64"),
        "init.init_style": ("gertz", "mehrotra"),
    }
    if kkt.kkt_solver_type == "clever_symmetric":
        choices["kkt.kkt_system_rescale"] = ("none", "u_only", "u_and_x")
    for key, allowed in choices.items():
        val = _option(pars, key)
        if val not in allowed:
            raise ValueError(f"{key}={val!r}: expected one of {allowed}")
    # "eigh" factors the symmetric paths spectrally; on the schur path the
    # JAX package runs it as the xla lane, and so does the port
    if kkt.linear_solver_type not in ("xla", "invchol", "pallas", "eigh"):
        raise NotImplementedError(
            f"kkt.linear_solver_type={kkt.linear_solver_type!r} is not "
            "ported to onephase_tpu_torch (xla, invchol, pallas, eigh)")
    with _mm_precision_ctx(pars.matmul_precision):
        pass


class OnePhaseKernel:
    """Solver kernel for one canonical problem + parameter set."""

    def __init__(self, nlp: CanonNLP, pars: Params):
        _check_supported(pars)
        self.nlp = nlp
        self.pars = pars
        self.dtype = nlp.dtype
        self.device = nlp.device
        n, m = nlp.n, nlp.m
        self.n, self.m = n, m
        self.lane = pars.kkt.linear_solver_type
        # host reads of device values inside the loops (see module doc)
        self.host_syncs = 0

        # per-row fraction-to-boundary vectors (Class_iterate.jl:66-67;
        # linear rows relaxed by the Mehrotra init, init.jl:78-79)
        fb = np.full(m, pars.ls.fraction_to_boundary)
        fbp = np.full(m, pars.ls.fraction_to_boundary_predict)
        if pars.init.init_style == "mehrotra":
            fb[nlp.lin_mask] = pars.ls.fraction_to_boundary_linear
            fbp[nlp.lin_mask] = pars.ls.fraction_to_boundary_linear
        self.frac_bd = torch.as_tensor(fb, dtype=self.dtype,
                                       device=self.device)
        self.frac_bd_predict = torch.as_tensor(fbp, dtype=self.dtype,
                                               device=self.device)

        cap_hint = pars.history_capacity
        self.hist_cap = cap_hint if cap_hint > 0 else (
            pars.term.max_it * pars.max_it_corrections + 2)
        self.filt_cap = pars.term.max_it * pars.max_it_corrections + 2

        # the reference's delta.max = 1e50 overflows f32; clamp to the dtype
        finfo_max = float(torch.finfo(self.dtype).max)
        self.delta_max = min(pars.delta.max, finfo_max / 64.0)

        # precision knobs of float64 solves (onephase_tpu/ipm/core.py:
        # 132-174).  kkt.factor_precision: Q, its Cholesky factor and the
        # solve operator in float32, the refinement residual in float64
        # from the float64 J/H ("f32": carried in float32; "f32_fallback":
        # a float32 attempt, redone in float64 where the strict pivot
        # screen rejects it, carried in float64).
        kkt = pars.kkt
        self.kkt_type = kkt.kkt_solver_type
        schur = self.kkt_type == "schur"
        f32, f64 = torch.float32, torch.float64
        fp = kkt.factor_precision
        mixed = fp in ("f32", "f32_fallback") and self.dtype == f64
        # the symmetric paths refine against the stored K, which a float32
        # factor would leave at float32 quality
        if mixed and not schur:
            raise ValueError(
                "kkt.factor_precision requires kkt_solver_type='schur'")
        self.factor_dtype = f32 if mixed else self.dtype
        self.factor_store_dtype = (f32 if (mixed and fp == "f32")
                                   else self.dtype)
        # kkt.fallback_form_f32: Q formed and carried in float32; the
        # fallback re-forms the float64 Q from the float64 J/H
        self._fb_form_f32 = (mixed and fp == "f32_fallback"
                             and kkt.fallback_form_f32)
        self.q_store_dtype = (f32 if self._fb_form_f32
                              else self.factor_store_dtype)
        # kkt.hi_matvec_f32pair: the refinement's ("refine") and also the
        # direction's ("all") J products as float32 pairs (ops/refine.py)
        hip = kkt.hi_matvec_f32pair
        self._hi_pair = (hip in ("all", "refine") and self.dtype == f64
                         and schur)
        self._hi_pair_dir = self._hi_pair and hip == "all"
        # kkt.precond_f32: the solve operator M carried in float32
        self._precond_f32 = (kkt.precond_f32 and self.dtype == f64 and schur
                             and self.lane in ("invchol", "pallas"))
        self.L_store_dtype = (f32 if self._precond_f32
                              else self.factor_store_dtype)

        # constant-structure problems: J and H evaluated once, shared by the
        # whole batch as one (m_orig, n) / (n, n) tensor (batch stride 0 in
        # the kernels); a declared-zero Hessian is never formed at all
        x0 = torch.as_tensor(nlp.x0, dtype=self.dtype,
                             device=self.device)[None]
        spec = nlp.spec
        # a matrix-free structured kernel (BandedKernel) sets
        # `_skip_const_fold` before this constructor runs: it never
        # materializes J or H, not even as folded constants
        fold = not getattr(self, "_skip_const_fold", False)
        # the symmetric paths block H into K: a declared-zero Hessian is
        # then a folded constant zero block, as in the JAX package
        self._H_zero = bool(spec.zero_hess) and schur
        cjac = spec.constant_jac and fold
        chess = spec.constant_hess and not self._H_zero and fold
        # parametric constant structure: evaluated once per solve from the
        # instance's data (_initial_state) and carried in the Factor
        self._param_const_jac = cjac and nlp.parametric
        self._param_const_hess = chess and nlp.parametric
        self._Jc_const = (nlp.jac_orig(x0)[0].contiguous()
                          if cjac and not nlp.parametric else None)
        self._H_const = (nlp.lag_hess(x0, self._full((1, m), 0.0))[0]
                         .contiguous()
                         if chess and not nlp.parametric else None)

        # the dense path carries no Q: it is cheap to rebuild from the J/H at
        # the factor point (_fact_q), and carrying it doubles the factor
        # state.  Structured subclasses (parallel/chain.py) keep their own Q
        # representation in the Factor (onephase_tpu/ipm/core.py:228-233).
        self._q_store_placeholder = (
            schur and type(self).form_factor is OnePhaseKernel.form_factor
            and type(self).factor is OnePhaseKernel.factor)

        # clever_symmetric: groups of parallel canonical rows, detected once
        # at the projected start (reference initialize!,
        # clever_symmetric.jl:54-62) by the port's native library.  A
        # group's sums run over its member table in row order (padding
        # points at a zero column): deterministic, where index_add_ on
        # the card accumulates with atomics.
        self.mr = m
        if self.kkt_type == "clever_symmetric":
            from ..native import detect_parallel_rows
            x_init = self.project_bounds(x0, nlp.default_bvals())
            Jcan0 = nlp.jac_canonical(nlp.jac_orig(x_init))[0]
            group_id, ratio, _ = detect_parallel_rows(Jcan0.cpu().numpy())
            roots, row2group = np.unique(group_id, return_inverse=True)
            self.mr = len(roots)
            counts = np.bincount(row2group, minlength=self.mr)
            members = np.full((self.mr, counts.max()), m, dtype=np.int64)
            fill = np.zeros(self.mr, dtype=np.int64)
            for row, g in enumerate(row2group):
                members[g, fill[g]] = row
                fill[g] += 1

            def idx(a):
                return torch.as_tensor(a, dtype=torch.long,
                                       device=self.device)

            self.clever_roots = idx(roots)                      # (mr,)
            self.clever_row2group = idx(row2group)              # (m,)
            self.clever_members = idx(members)                  # (mr, g)
            self.clever_ratio = torch.as_tensor(ratio, dtype=self.dtype,
                                                device=self.device)

    # ------------------------------------------------------------------
    def _full(self, shape, val, dtype=None):
        return torch.full(shape, val, dtype=dtype or self.dtype,
                          device=self.device)

    def _any(self, mask) -> bool:
        """The one host read a loop trip may make (counted)."""
        self.host_syncs += 1
        return bool(mask.any())

    def _group_sum(self, v):
        """Per clever group, the sum of v (B, m) over its rows in row order
        -> (B, mr): jax.ops.segment_sum's sequential order."""
        vp = torch.cat([v, v.new_zeros(v.shape[0], 1)], -1)
        out = v.new_zeros(v.shape[0], self.mr)
        for k in range(self.clever_members.shape[1]):
            out = out + vp[:, self.clever_members[:, k]]
        return out

    def initial_state(self):
        x0 = torch.as_tensor(self.nlp.x0, dtype=self.dtype,
                             device=self.device)
        return self.initial_state_from(x0[None])

    def initial_state_from(self, x0, bvals=None, pdata=None):
        with _mm_precision_ctx(self.pars.matmul_precision):
            return self._initial_state(x0, bvals, pdata)

    def run_chunk(self, st: State) -> State:
        return self._run_chunk(st)

    # ==================================================================
    # residual / merit evaluations (reference: src/utils/eval.jl)
    # ==================================================================
    def grad_lag(self, cache: Cache, y_unused, mu):
        """∇L(x, y, mu) = g - J^T y + mu * theta * J^T 1."""
        th = self.pars.a_norm_penalty
        return cache.g - cache.jt_y + _c(mu * th) * cache.jt_ones

    def dual_scale(self, y, s=None):
        mode = self.pars.term.dual_scale_mode
        thr = self.pars.term.dual_scale_threshold
        ninf = _norm_inf(y)
        if mode == "max_dual":
            return thr / torch.clamp(ninf, min=thr)
        if mode == "ipopt":
            return thr / torch.clamp(y.mean(-1), min=thr)
        if mode == "sqrt":
            return thr / torch.clamp(torch.sqrt(ninf), min=thr)
        if mode == "exact":
            return torch.ones_like(ninf)
        if mode == "primal_dual":
            if s is None:
                raise ValueError("primal_dual dual scale needs slacks")
            return thr / torch.clamp(torch.sqrt(ninf * _norm_inf(s)),
                                     min=thr)
        raise ValueError(f"dual_scale_mode {mode}")

    def comp(self, p: Point):
        return p.s * p.y - _c(p.mu)

    def is_feasible(self, p: Point, comp_feas):
        """Interior invariant (IPM_tools.jl:51-64).  NaN-safe."""
        sy = p.s * p.y
        ok = ((p.s > 0.0).all(-1) & (p.y > 0.0).all(-1)
              & (sy.amax(-1) / p.mu <= 1.0 / comp_feas)
              & (sy.amin(-1) / p.mu >= comp_feas))
        finite = (torch.isfinite(p.mu) & ~_isbad(p.s) & ~_isbad(p.y)
                  & ~_isbad(p.x))
        return ok & finite

    def eval_phi(self, p: Point, cache: Cache, mu):
        """Shifted log barrier phi_mu (eval.jl:118-124)."""
        th = self.pars.a_norm_penalty
        safe_s = torch.where(p.s > 0.0, p.s, torch.ones_like(p.s))
        val = (cache.fval - mu * torch.log(safe_s).sum(-1)
               + mu * th * cache.a.sum(-1))
        return torch.where((p.s > 0.0).all(-1), val,
                           torch.full_like(val, float("inf")))

    def eval_merit(self, p: Point, cache: Cache):
        """phi + ||comp||_inf^3 / mu^2, Inf outside the interior."""
        pen = _norm_inf(self.comp(p)) ** 3 / p.mu ** 2
        val = self.eval_phi(p, cache, p.mu) + pen
        return torch.where(self.is_feasible(p, self.pars.ls.comp_feas), val,
                           torch.full_like(val, float("inf")))

    def merit_diff(self, p, cache, pc: Point, cc: Cache):
        """eval_merit_function_difference (eval.jl:192-208)."""
        mu_c = pc.mu
        th = self.pars.a_norm_penalty
        fdiff = cc.fval - cache.fval
        rdiff = mu_c * th * (cc.a.sum(-1) - cache.a.sum(-1))
        pos = (pc.s > 0) & (p.s > 0)
        safe = torch.where(pos, pc.s / p.s, torch.ones_like(p.s))
        logdiff = -mu_c * torch.log(safe).sum(-1)
        comp_pen = ((_norm_inf(self.comp(pc)) ** 3
                     - _norm_inf(self.comp(p)) ** 3) / p.mu ** 2)
        val = fdiff + rdiff + logdiff + comp_pen
        feas = (self.is_feasible(pc, self.pars.ls.comp_feas)
                & (pc.s > 0).all(-1))
        return torch.where(feas, val, torch.full_like(val, float("inf")))

    def scaled_dual_feas(self, p: Point, cache: Cache, mu):
        return (_norm_inf(self.grad_lag(cache, p.y, mu))
                * self.dual_scale(p.y, p.s))

    # ==================================================================
    # cache construction
    # ==================================================================
    def make_cache(self, x, y, bvals=None, pdata=None):
        nlp = self.nlp
        cons = nlp.c(x, pdata)
        a = nlp.a_of(x, cons, bvals)
        fval = nlp.f(x, pdata)
        g = nlp.grad_f(x, pdata)
        jt_y = nlp.jtprod(x, y, pdata)
        jt_ones = nlp.jtprod_ones(x, pdata)
        return Cache(fval=fval, cons=cons, a=a, g=g, jt_y=jt_y,
                     jt_ones=jt_ones)

    # ==================================================================
    # linear algebra: factor + solve (reference: julia.jl:21-97)
    # ==================================================================
    def factor(self, Q, delta, rescale=None, fact=None):
        """Factor the KKT matrix with delta on the x-diagonal per instance;
        returns ((L, D), ok).

        Symmetric paths: unpivoted LDL^T (or eigh) of K + diag(delta r_x^2,
        0), inertia from the signs of D (or of the eigenvalues), which must
        be (n, mr) (julia.jl:70-90).  `rescale` (clever_symmetric under
        kkt_system_rescale): Q holds R K R, so the shift is delta * r^2.

        Schur path: Cholesky of Q + delta*I; inertia == Cholesky success,
        with the relative pivot screen of `_chol_ok` (the dense stand-in for
        CHOLMOD's PosDefException).

        Under `kkt.factor_precision="f32_fallback"` (float64 solves) every
        instance first takes a float32 factor under the strict screen; where
        it is rejected, the float64 factor replaces it (the JAX package's
        `lax.cond`, whose branches under vmap run for the whole batch and
        are selected per instance: the same values).  The float64 factor
        runs only when some instance needs it (one host read).  Under
        `kkt.fallback_form_f32` Q is float32 and the fallback re-forms the
        float64 Q from `fact`'s float64 J/H, with the lane's Q kernel."""
        if self.kkt_type in SYMMETRIC:
            n = self.n
            Kd = Q.clone(memory_format=torch.contiguous_format)
            Kd.diagonal(dim1=-2, dim2=-1)[:, :n].add_(
                self._x_shift(delta.to(Q.dtype), rescale))
            if self.lane == "eigh":
                V, w = ldlt_mod.eigh_inertia(Kd)
                return (V, w), ldlt_mod.inertia_status(w, n, self.mr)
            L, d = ldlt_mod.ldlt(Kd)
            return (L, d), ldlt_mod.inertia_status(d, n, self.mr)
        Qd = Q.clone(memory_format=torch.contiguous_format)
        Qd.diagonal(dim1=-2, dim2=-1).add_(_c(delta.to(Q.dtype)))
        D = torch.ones(Q.shape[:-1], dtype=self.factor_store_dtype,
                       device=Q.device)
        if (self.factor_dtype == self.dtype
                or self.pars.kkt.factor_precision != "f32_fallback"):
            L, ok = self._chol_ok(Qd)
            return (L, D), ok
        L32, ok32 = self._chol_ok(Qd.to(torch.float32), strict=True)
        L = L32.to(self.dtype)
        if not self._any(~ok32):
            return (L, D), ok32
        if Q.dtype == torch.float32:              # kkt.fallback_form_f32
            Qd = self.nlp.jtdj_fused(self._fact_jc(fact), fact.y_f / fact.s_f,
                                     self._fact_h(fact),
                                     use_pallas=self.lane == "pallas")
            Qd.diagonal(dim1=-2, dim2=-1).add_(_c(delta.to(self.dtype)))
        L64, ok64 = self._chol_ok(Qd)
        return (tree_select(ok32, L, L64), D), ok32 | ok64

    def _chol_ok(self, Qd, strict=False):
        """Cholesky + pivot screening in Qd's own dtype: pivots positive
        and finite, and min(d)^2 > tol * max(d)^2 with tol =
        max(chol_pivot_tol, eps/2), or 64*eps when `strict`."""
        eps = float(torch.finfo(Qd.dtype).eps)
        tol = max(self.pars.kkt.chol_pivot_tol,
                  64.0 * eps if strict else eps / 2.0)
        if self.lane == "pallas":
            L, d, pok = pallas_chol(Qd)          # hand kernel (ops/cholesky)
        else:
            # jnp.linalg.cholesky fills NaN when the factorization fails;
            # cholesky_ex reports it through LAPACK's info instead
            L, d, pok = xla_chol(Qd)
        finite = torch.isfinite(d).all(-1) & pok
        pos = (d > 0).all(-1)
        rel_ok = d.amin(-1) ** 2 > tol * d.amax(-1) ** 2
        return L, finite & pos & rel_ok

    # ------------------------------------------------------------------
    # factor-point product hooks: constant-structure problems read the
    # shared folded J/H here instead of carrying per-instance copies
    def _fact_jc(self, fact: Factor):
        return self._Jc_const if self._Jc_const is not None else fact.Jc

    def _fact_h(self, fact: Factor):
        if self._H_zero:
            return None
        return self._H_const if self._H_const is not None else fact.H

    def fact_jprod(self, fact: Factor, v):
        """Canonical J @ v at the factorization point (as float32 pairs
        under `kkt.hi_matvec_f32pair="all"`)."""
        if self._hi_pair_dir and self.nlp.m_orig > 0:
            jc_v = dsr.pair_matvec64(self._fact_jc(fact), v)
            return self.nlp.jprod_from(jc_v, v)
        return self.nlp.jprod_mat(self._fact_jc(fact), v)

    def fact_jtprod(self, fact: Factor, w):
        """Canonical J^T @ w at the factorization point (as float32 pairs
        under `kkt.hi_matvec_f32pair="all"`)."""
        if self._hi_pair_dir and self.nlp.m_orig > 0:
            wc, bnd = self.nlp.split_canonical(w)
            return dsr.pair_matvec64_t(self._fact_jc(fact), wc) + bnd
        return self.nlp.jtprod_mat(self._fact_jc(fact), w)

    def fact_hmul(self, fact: Factor, v):
        """Lagrangian-Hessian product H @ v at the factorization point."""
        if self._H_zero:
            return torch.zeros_like(v)
        return _mv(self._fact_h(fact), v)

    def _store_jc(self, Jc):
        return None if self._Jc_const is not None else Jc

    def _store_h(self, H):
        return None if (self._H_zero or self._H_const is not None) else H

    def _store_q(self, Q):
        """Value carried in Factor.Q: None on the dense path (see
        __init__), the structured kernel's own Q otherwise."""
        return None if self._q_store_placeholder else Q

    def _fact_q(self, fact: Factor):
        """Q at the factorization point: rebuilt from the factor-point J/H
        on the dense path (the carried Factor holds no Q), the carried Q of
        a structured kernel."""
        if not self._q_store_placeholder:
            return fact.Q
        return self._form_q(self._fact_jc(fact), self._fact_h(fact),
                            fact.y_f / fact.s_f)

    def _form_q(self, Jc, H, d):
        """Fused Q = H + J^T diag(d) J (the 42.1% cost item) in the dtype Q
        is carried in: float32 operands cast from the float64 solve under
        the float32 factor knobs (then the Q kernel runs in float32), and
        the bf16 scale-split under `kkt.q_form_dtype="bf16"`."""
        mxu = (torch.bfloat16 if self.pars.kkt.q_form_dtype == "bf16"
               else None)
        fdt = self.q_store_dtype
        if fdt != self.dtype:
            Jc, d = Jc.to(fdt), d.to(fdt)
            H = None if H is None else H.to(fdt)
        return self.nlp.jtdj_fused(Jc, d, H, use_pallas=self.lane == "pallas",
                                   mxu_dtype=mxu)

    def finalize_solver(self, L):
        """Turn an accepted Cholesky factor into the solve operator: the
        explicit inverse M = L^-T L^-1 on the pallas/invchol lanes (every
        backsolve is then one batched matvec), L itself on the xla lane.
        Under `kkt.precond_f32` M is built and carried in float32.  The
        symmetric paths carry their factor as it is."""
        if self.kkt_type != "schur":
            return L
        if self._precond_f32:
            L = L.to(torch.float32)
        if self.lane == "pallas":
            return pallas_tri_inv_gram(L)          # hand kernel
        if self.lane == "invchol":
            return xla_chol_inv_from_L(L)
        return L

    def chol_solve(self, L, b):
        """Apply the solve operator produced by factor + finalize_solver,
        in the operator's dtype (float32 under the float32 factor knobs:
        the refinement supplies the rest); the result in b's dtype."""
        out_dt = b.dtype
        b = b.to(L.dtype)
        if self.lane in ("pallas", "invchol"):
            return _mv(L, b).to(out_dt)            # L slot holds M = Q^-1
        z = torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=False)
        return torch.linalg.solve_triangular(
            L.transpose(-1, -2), z, upper=True).squeeze(-1).to(out_dt)

    def sym_backsolve(self, fact: Factor, b):
        """Backsolve with the symmetric paths' factor: LDL^T, or the
        spectral pair under linear_solver_type="eigh"."""
        out_dt = b.dtype
        b = b.to(fact.L.dtype)
        if self.lane == "eigh":
            return ldlt_mod.eigh_solve(fact.L, fact.D, b).to(out_dt)
        return ldlt_mod.ldlt_solve(fact.L, fact.D, b).to(out_dt)

    # ==================================================================
    # KKT system (reference: schur.jl, symmetric.jl, clever_symmetric.jl)
    # ==================================================================
    def form_factor(self, p: Point, cache: Cache, prev: Factor,
                    pdata=None) -> Factor:
        """form_system!: Q = H_L + J^T diag(y/s) J with H at the shifted
        duals y + mu*theta (update_H!, Class_iterate.jl:279-311).

        Symmetric path: Q holds K = [[H, J^T], [J, -S/Y]]
        (symmetric.jl:35-53); clever_symmetric: the merged system
        [[H, J_root^T], [J_root, -diag(group_u)]] with group_u =
        1 / sum(ratio^2 / u) over each group (clever_symmetric.jl:271-393),
        as R K R under kkt_system_rescale.  Both keep the Schur diagonal
        in `schur_diag` for the tau test (kkt_system_solver.jl:296-300)."""
        nlp = self.nlp
        y_eff = p.y + _c(p.mu * self.pars.a_norm_penalty)
        H, Jc = self._factor_point_jh(p, prev, y_eff, pdata)
        if self.kkt_type in SYMMETRIC:
            return self._form_sym(p, prev, Jc, H)
        Q = self._form_q(Jc, H, p.y / p.s)
        return Factor(Jc=self._store_jc(Jc), H=self._store_h(H), Q=Q,
                      schur_diag=torch.diagonal(Q, dim1=-2, dim2=-1).to(
                          self.dtype, copy=True),
                      L=prev.L, D=prev.D, delta=prev.delta, s_f=p.s, y_f=p.y,
                      ok=torch.zeros_like(prev.ok))

    def _factor_point_jh(self, p: Point, prev: Factor, y_eff, pdata):
        """(H, Jc) at the factor point: None for a declared-zero H, the
        folded constant, the per-solve value carried in `prev` (parametric
        constant structure) or a fresh evaluation."""
        nlp = self.nlp
        if self._H_zero:
            H = None
        elif self._H_const is not None:
            H = self._H_const
        elif self._param_const_hess:
            H = prev.H          # evaluated once per solve in _initial_state
        else:
            H = nlp.lag_hess(p.x, y_eff, pdata).contiguous()
        if self._Jc_const is not None:
            Jc = self._Jc_const
        elif self._param_const_jac:
            Jc = prev.Jc        # evaluated once per solve in _initial_state
        else:
            Jc = nlp.jac_orig(p.x, pdata).contiguous()
        return H, Jc

    def _form_sym(self, p: Point, prev: Factor, Jc, H) -> Factor:
        nlp = self.nlp
        B, n = p.x.shape
        Jcan = nlp.jac_canonical(Jc)
        r = None
        if self.kkt_type == "symmetric":
            J, C = Jcan, p.s / p.y
        else:
            u = p.s / p.y
            C = 1.0 / self._group_sum(self.clever_ratio ** 2 / u)  # group_u
            J = Jcan[..., self.clever_roots, :]
            rmode = self.pars.kkt.kkt_system_rescale
            if rmode != "none":
                rx = torch.ones_like(p.x)
                if rmode == "u_and_x":
                    rx = rx / _c(torch.sqrt(1.0 + _norm_inf(p.x)))
                r = torch.cat([rx, _c(p.mu) / torch.sqrt(C)], -1)
        N = n + J.shape[-2]
        K = p.x.new_zeros(B, N, N)
        K[:, :n, :n] = H
        K[:, :n, n:] = J.transpose(-1, -2)
        K[:, n:, :n] = J
        K[:, n:, n:] = -torch.diag_embed(C)
        if r is not None:
            K = r[:, :, None] * K * r[:, None, :]
        H_diag = torch.diagonal(H, dim1=-2, dim2=-1)
        schur_diag = H_diag + nlp.jtdj_diag(Jc, p.y / p.s)
        return Factor(Jc=self._store_jc(Jc), H=self._store_h(H), Q=K,
                      schur_diag=schur_diag, L=prev.L, D=prev.D,
                      delta=prev.delta, s_f=p.s, y_f=p.y,
                      ok=torch.zeros_like(prev.ok), rescale=r)

    def _refine_tol(self):
        return self.pars.kkt.it_refine_tol or 10.0 * float(
            torch.finfo(self.dtype).eps)

    def _refine_loop(self, one_pass, carry, res_of, schur_rhs):
        """Fixed-count or adaptive refinement over `carry` with `one_pass`;
        `res_of(carry)` is the residual the adaptive exit reads."""
        kkt = self.pars.kkt
        if not kkt.it_refine_adaptive:
            for _ in range(kkt.it_refine_num):
                carry = one_pass(*carry)
            return carry
        # adaptive: refine until ||res||_inf <= tol * ||rhs||_inf or
        # it_refine_max passes, per instance
        tol_rhs = self._refine_tol() * _norm_inf(schur_rhs)
        i = torch.zeros(schur_rhs.shape[0], dtype=INT, device=self.device)
        while True:
            active = ((i < kkt.it_refine_max)
                      & (_norm_inf(res_of(carry)) > tol_rhs))
            if not self._any(active):
                return carry
            carry = tree_select(active, one_pass(*carry), carry)
            i = i + active.to(INT)

    def refine_solve(self, fact: Factor, schur_rhs):
        """Iterative refinement of the Schur solve (schur.jl:131-182):
        fixed-count, adaptive, or with double-single residuals
        (`kkt.it_refine_highprec`, ops/refine.py)."""
        S_vec = fact.y_f / fact.s_f
        if self.pars.kkt.it_refine_highprec:
            return self._refine_solve_hp(fact, schur_rhs, S_vec)
        delta = _c(fact.delta)

        def one_pass(dx, res):
            dx = dx + self.chol_solve(fact.L, res)
            jac_res = self.fact_jtprod(fact, S_vec * self.fact_jprod(fact, dx))
            hess_res = self.fact_hmul(fact, dx) + delta * dx
            return dx, schur_rhs - (jac_res + hess_res)

        dx, _ = self._refine_loop(one_pass,
                                  (torch.zeros_like(schur_rhs), schur_rhs),
                                  lambda c: c[1], schur_rhs)
        return dx

    def _refine_solve_hp(self, fact: Factor, schur_rhs, S_vec):
        nlp = self.nlp
        if self._hi_pair:
            return self._refine_solve_pair(fact, schur_rhs, S_vec)
        wc, bnd = nlp.split_canonical_sq(S_vec)
        diag_term = bnd + _c(fact.delta)     # bound rows of J^T D J + delta
        zeros = torch.zeros_like(schur_rhs)
        Jc = self._fact_jc(fact)
        H = self._fact_h(fact)

        def one_pass(dx_hi, dx_lo, res_hi, res_lo):
            e = self.chol_solve(fact.L, res_hi + res_lo)
            dx_hi, dx_lo = dsr.ds_add(dx_hi, dx_lo, e, torch.zeros_like(e))
            # A dx = Jc^T (wc * (Jc dx)) + (bnd + delta) dx + H dx, all ds
            if nlp.m_orig > 0:
                u_hi, u_lo = dsr.ds_matvec(Jc, dx_hi, dx_lo)
                v_hi, v_e = dsr.two_prod(wc, u_hi)
                v_lo = v_e + wc * u_lo
                w_hi, w_lo = dsr.ds_matvec(Jc.transpose(-1, -2), v_hi, v_lo)
            else:
                w_hi, w_lo = zeros, zeros
            if self._H_zero:
                h_hi, h_lo = zeros, zeros
            else:
                h_hi, h_lo = dsr.ds_matvec(H, dx_hi, dx_lo)
            d_hi, d_e = dsr.two_prod(diag_term, dx_hi)
            d_lo = d_e + diag_term * dx_lo
            a_hi, a_lo = dsr.ds_add(w_hi, w_lo, h_hi, h_lo)
            a_hi, a_lo = dsr.ds_add(a_hi, a_lo, d_hi, d_lo)
            res_hi, res_lo = dsr.ds_add(schur_rhs, zeros, -a_hi, -a_lo)
            return dx_hi, dx_lo, res_hi, res_lo

        dx_hi, dx_lo, _, _ = self._refine_loop(
            one_pass, (zeros, zeros, schur_rhs, zeros),
            lambda c: c[2] + c[3], schur_rhs)
        return dx_hi + dx_lo

    def _refine_solve_pair(self, fact: Factor, schur_rhs, S_vec):
        """`kkt.hi_matvec_f32pair` on a float64 solve: the carry (dx, res)
        stays float64, the residual's J products run as float32 pairs
        (onephase_tpu/ipm/core.py:717-757)."""
        nlp = self.nlp
        wc, bnd = nlp.split_canonical_sq(S_vec)
        diag_term = bnd + _c(fact.delta)
        Jc = self._fact_jc(fact)

        def one_pass(dx, res):
            dx = dx + self.chol_solve(fact.L, res)
            if nlp.m_orig > 0:
                u = dsr.pair_matvec64(Jc, dx)
                w = dsr.pair_matvec64_t(Jc, wc * u)
            else:
                w = torch.zeros_like(dx)
            h = self.fact_hmul(fact, dx)
            return dx, schur_rhs - (w + h + diag_term * dx)

        dx, _ = self._refine_loop(one_pass,
                                  (torch.zeros_like(schur_rhs), schur_rhs),
                                  lambda c: c[1], schur_rhs)
        return dx

    def build_rhs(self, p: Point, cache: Cache, eta_P, eta_D, eta_mu,
                  pdata=None):
        """System_rhs (system_rhs.jl:39-74); eta_* are (B,) tensors.  Under
        `kkt.residual_precision="f64"` the dual residual comes from one
        float64 oracle pass (only its float cast enters the solve dtype)."""
        if self.pars.kkt.residual_precision == "f64":
            th = self.pars.a_norm_penalty
            gl = self.nlp.grad_lag_hi(
                p.x, p.y, (p.mu * eta_mu * th).to(torch.float64),
                pdata).to(self.dtype)
        else:
            gl = self.grad_lag(cache, p.y, p.mu * eta_mu)
        dual_r = -_c(1.0 - eta_D) * gl
        primal_r = -_c(1.0 - eta_P) * (cache.a - p.s)
        comp_r = _c(p.mu * eta_mu) - p.s * p.y
        return dual_r, primal_r, comp_r

    def compute_direction(self, fact: Factor, p: Point, cache: Cache,
                          eta_P, eta_D, eta_mu,
                          pdata=None) -> Tuple[Dir, torch.Tensor]:
        """compute_direction_implementation! (schur.jl:89-128) + the
        a-posteriori KKT error ratio (kkt_system_solver.jl:49-96)."""
        dual_r, primal_r, comp_r = self.build_rhs(p, cache, eta_P, eta_D,
                                                  eta_mu, pdata)
        y_f, s_f = fact.y_f, fact.s_f
        S_vec = y_f / s_f
        sym_primal = primal_r + comp_r / y_f
        if self.kkt_type == "schur":
            schur_rhs = dual_r + self.fact_jtprod(
                fact, primal_r * S_vec + comp_r / s_f)
            dx = self.refine_solve(fact, schur_rhs)
            jdx = self.fact_jprod(fact, dx)
            dy = -(jdx - sym_primal) * S_vec
        else:
            dx, dy = self._sym_direction(fact, dual_r, sym_primal)
            jdx = self.fact_jprod(fact, dx)
        ds = jdx - primal_r
        dmu = -(1.0 - eta_mu) * p.mu
        dbeta = -(1.0 - eta_P) * p.beta
        direction = Dir(x=dx, y=dy, s=ds, mu=dmu, beta=dbeta)

        pred_lag = (_c(fact.delta) * dx + self.fact_hmul(fact, dx)
                    - self.fact_jtprod(fact, dy))
        err_D = pred_lag - dual_r
        err_P = jdx - ds - primal_r
        err_mu = s_f * dy + y_f * ds - comp_r
        overall = _norm_inf(torch.cat([err_D, err_P, err_mu], -1))
        rhs_norm = _norm_inf(torch.cat([dual_r, primal_r, comp_r], -1))
        return direction, overall / rhs_norm

    def _x_shift(self, delta, rescale):
        """The delta shift of the x-diagonal (B, n): delta, or delta r_x^2
        when Q holds the rescaled R K R."""
        xs = _c(delta).expand(-1, self.n)
        return xs if rescale is None else xs * rescale[:, :self.n] ** 2

    def _sym_direction(self, fact: Factor, dual_r, sym_primal):
        """(dx, dy) of the symmetric paths.  symmetric: the joint solve
        K [dx; -dy] = [dual_r; sym_primal] (symmetric.jl:59-83).
        clever_symmetric: the reduced joint solve and the per-row dual
        reconstitution (clever_symmetric.jl:425-493), in the rescaled
        variables: (RKR + delta RER) w = R rhs, then the direction R w.
        Both refine it_refine_num fixed passes against the stored K (the
        unpivoted LDL^T loses digits the reference's pivoted CHOLMOD
        keeps; refinement restores them)."""
        n = self.n
        if self.kkt_type == "symmetric":
            rhs = torch.cat([dual_r, sym_primal], -1)
        else:
            u = fact.s_f / fact.y_f
            seg, ratio = self.clever_row2group, self.clever_ratio
            group_u = 1.0 / self._group_sum(ratio ** 2 / u)
            rhs_red = self._group_sum(group_u[:, seg] * ratio / u
                                      * sym_primal)
            rhs = torch.cat([dual_r, rhs_red], -1)
        if fact.rescale is not None:
            rhs = rhs * fact.rescale
        shift = torch.cat([self._x_shift(fact.delta, fact.rescale),
                           rhs.new_zeros(rhs.shape[0], rhs.shape[1] - n)],
                          -1)
        sol = torch.zeros_like(rhs)
        res = rhs
        for _ in range(self.pars.kkt.it_refine_num):
            sol = sol + self.sym_backsolve(fact, res)
            res = rhs - (_mv(fact.Q, sol) + shift * sol)
        if fact.rescale is not None:
            sol = sol * fact.rescale
        if self.kkt_type == "symmetric":
            return sol[:, :n], -sol[:, n:]
        tmp = -(rhs_red + group_u * sol[:, n:])
        return sol[:, :n], sym_primal / u + (ratio / u) * tmp[:, seg]

    # ==================================================================
    # delta / inertia strategy (reference: delta_strategy.jl:37-121)
    # ==================================================================
    def ipopt_strategy(self, fact: Factor, iter_delta, active=None):
        """Returns (success, num_fac, new_delta, (L, D)).  `active` limits
        the δ-search trips to the instances whose result is kept.  L may be
        a tuple of tensors (a structured kernel's block factor)."""
        pars = self.pars
        B = iter_delta.shape[0]
        if active is None:
            active = torch.ones(B, dtype=torch.bool, device=self.device)

        tau = 1.5 * fact.schur_diag.amin(-1)
        try_zero = tau > 0.0
        # both cond branches: the zero-delta attempt runs for every instance
        LD0, ok0 = self.factor(fact.Q, self._full((B,), pars.delta.zero),
                               fact.rescale, fact=fact)
        # the stale factor of the other branch is the finalized operator,
        # carried in L_store_dtype; the raw factor's dtype is
        # factor_store_dtype (they differ under kkt.precond_f32).  A
        # structured kernel's factor is a tuple of blocks.
        L_prev = fact.L
        if self.L_store_dtype != self.factor_store_dtype:
            L_prev = _factor_to(L_prev, self.factor_store_dtype)
        L = tree_select(try_zero, LD0[0], L_prev)
        D = tree_select(try_zero, LD0[1], fact.D)
        ok0 = try_zero & ok0
        nfac = try_zero.to(INT)
        tau_eff = torch.where(try_zero, torch.zeros_like(tau), tau)

        delta = torch.where(
            iter_delta != 0.0,
            torch.maximum(pars.delta.min - tau_eff,
                          iter_delta * pars.delta.dec),
            pars.delta.start - tau_eff)
        ok = ok0
        i = torch.zeros(B, dtype=INT, device=self.device)
        while True:
            trip = (active & ~ok & (i < pars.delta.max_it)
                    & (delta <= self.delta_max))
            if not self._any(trip):
                break
            (Lc, Dc), okc = self.factor(fact.Q, delta, fact.rescale,
                                        fact=fact)
            upd = trip & okc       # keep the stale factor on failure
            L = tree_select(upd, Lc, L)
            D = tree_select(upd, Dc, D)
            next_delta = torch.where(okc, delta, delta * pars.delta.inc)
            delta = torch.where(trip, next_delta, delta)
            ok = torch.where(trip, okc, ok)
            nfac = nfac + trip.to(INT)
            i = i + trip.to(INT)

        # zero-delta attempt succeeded -> loop never ran -> delta.zero
        final_delta = torch.where(ok0, self._full((B,), pars.delta.zero),
                                  delta)
        return ok, nfac, final_delta, (L, D)

    # ==================================================================
    # fraction-to-boundary helpers (reference: frac_boundary.jl)
    # ==================================================================
    def lb_s_thres(self, s, dx):
        ex = self.pars.ls.fraction_to_boundary_predict_exp
        nx = _norm_inf(dx)
        return torch.minimum(s, _c(nx * nx ** ex))

    def lb_s_predict(self, s, dx):
        return self.frac_bd_predict * self.lb_s_thres(s, dx)

    def lb_s(self, s, dx):
        return self.frac_bd * self.lb_s_thres(s, dx)

    def lb_y(self, y, dx):
        return self.frac_bd * y * _c(torch.clamp(_norm_inf(dx), max=1.0))

    @staticmethod
    def simple_max_step(val, d, lb):
        gap = val - lb
        pos = gap > 0
        r = torch.where(pos, -d / torch.where(pos, gap, torch.ones_like(gap)),
                        torch.full_like(gap, float("inf")))
        rmax = r.amax(-1) if r.shape[-1] else r.new_zeros(r.shape[:-1])
        return 1.0 / torch.clamp(rmax, min=1.0)

    # ==================================================================
    # dual step machinery (reference: move.jl)
    # ==================================================================
    def dual_bounds(self, s_new, mu_new, y, dy):
        """Interval [lb, ub] of dual step sizes keeping s.y/mu in
        [comp_feas, 1/comp_feas] (move.jl:25-79), safety factor 1.001."""
        cf = self.pars.ls.comp_feas
        sf = 1.001
        dy_safe = torch.where(dy == 0, torch.ones_like(dy), dy)
        hi_bd = _c(mu_new) / (cf * s_new) - y
        lo_bd = _c(mu_new * cf) / s_new - y
        ub_dyi = hi_bd / dy_safe
        lb_dyi = lo_bd / dy_safe
        pos = dy > 0
        neg = dy < 0
        inf = torch.full_like(dy, float("inf"))
        lo_c = torch.where(pos, lb_dyi * sf, torch.where(neg, ub_dyi * sf, -inf))
        hi_c = torch.where(pos, ub_dyi / sf, torch.where(neg, lb_dyi / sf, inf))
        zero_bad = (dy == 0) & ((lo_bd >= 0.0) | (hi_bd <= 0.0))
        lb = torch.clamp(lo_c.amax(-1), min=0.0)
        ub = torch.clamp(hi_c.amin(-1), max=1.0)
        bad = zero_bad.any(-1) | ~torch.isfinite(lb) | ~torch.isfinite(ub)
        lb = torch.where(bad, torch.zeros_like(lb), lb)
        ub = torch.where(bad, -torch.ones_like(ub), ub)
        return lb, ub

    def _filter_ok(self, st, cand_p, cand_c, y_new, mu_new, alpha):
        """satisfies_filter! against every live filter entry."""
        pars = self.pars
        cand_merit = self.eval_merit(cand_p, cand_c)
        cand_kkt = _norm_inf(self.grad_lag(cand_c, y_new, mu_new))
        if pars.ls.kkt_include_comp:
            cand_kkt = cand_kkt + _norm_inf(self.comp(cand_p))
        cand_kkt = cand_kkt * self.dual_scale(y_new, cand_p.s)
        filt = st.filt
        idx = torch.arange(self.filt_cap, device=self.device)
        live = idx[None, :] < filt.count[:, None]
        kkt_red = (_c(cand_kkt) / filt.kkt
                   < _c(1.0 - pars.ls.kkt_reduction_factor * alpha))
        fval_no_inc = _c(cand_merit) < filt.merit + _c(torch.sqrt(cand_kkt))
        beta_dec = _c(cand_p.beta) < filt.beta
        ft = pars.ls.filter_type
        if ft == "test2":
            entry_ok = beta_dec | (kkt_red & fval_no_inc)
        elif ft == "default":
            entry_ok = beta_dec | kkt_red
        elif ft == "test1":
            fval_red = _c(cand_merit) < filt.merit - _c(cand_kkt ** 2)
            entry_ok = beta_dec | kkt_red | fval_red
        else:  # test3
            net = (_c(cand_kkt + cand_merit)
                   < filt.merit + filt.kkt - _c(cand_kkt ** 2))
            entry_ok = beta_dec | net
        return (entry_ok | ~live).all(-1)

    def _trial_tail(self, st, direction, be_agg, alpha, x_new, cons_new,
                    jt_new, a_new, beta_new, s_new, mu_new, nan_move,
                    lb_y_vec, predict_red):
        """Dual step + acceptance for one line-search trial (line_search.jl
        :100-126, move.jl:81-133 and the acceptance rules).  `jt_new`
        holds J(x_new)^T y, J(x_new)^T dy and J(x_new)^T 1 (canonical)."""
        nlp = self.nlp
        pars = self.pars
        p, cache = st.p, st.cache

        # --- dual bounds (line_search.jl:100-118) ----------------
        lb, ub = self.dual_bounds(s_new, mu_new, p.y, direction.y)
        ub = torch.minimum(ub, self.simple_max_step(p.y, direction.y,
                                                    lb_y_vec))
        dual_ok = lb < ub
        if not pars.ls.move_primal_seperate_to_dual:
            dual_ok = dual_ok & (lb <= alpha) & (alpha <= ub)

        # --- move_dual (move.jl:81-133) --------------------------
        g_new = nlp.grad_f(x_new, st.pdata)
        jt_y_old, jt_dy, jt_ones_new = jt_new
        th = pars.a_norm_penalty
        dual_res = g_new - jt_y_old + _c(mu_new * th) * jt_ones_new
        comp_new_old_y = s_new * p.y - _c(mu_new)
        scale = self.dual_scale(p.y, s_new)
        small_step = torch.maximum(lb, torch.minimum(ub, alpha))
        if pars.ls.dual_ls in (1, 3):
            qv = torch.cat([_c(scale) * jt_dy,
                            _c(scale) * s_new * direction.y], -1)
            prox = dual_res
            if pars.ls.dual_ls == 3:
                prox = dual_res + _c(st.delta) * direction.x * _c(alpha)
            res = torch.cat([_c(scale) * prox,
                             _c(-scale) * comp_new_old_y], -1)
            denom = (qv * qv).sum(-1)
            alpha_D = torch.where(denom > 0, (res * qv).sum(-1) / denom, ub)
            alpha_D = torch.minimum(torch.maximum(alpha_D, small_step), ub)
        elif pars.ls.dual_ls == 2:
            comp_term = comp_new_old_y.abs().amax(-1)
            initial_err = dual_res.abs().amax(-1) * scale + comp_term
            y_big = p.y + _c(ub) * direction.y
            big_err = ((dual_res - _c(ub) * jt_dy).abs().amax(-1)
                       * self.dual_scale(y_big, s_new)
                       + (s_new * y_big - _c(mu_new)).abs().amax(-1))
            take_big = big_err < initial_err * (
                1.0 - pars.ls.kkt_reduction_factor)
            alpha_D = torch.where(take_big, ub, small_step)
        else:  # dual_ls == 0
            alpha_D = ub
        y_new = p.y + direction.y * _c(alpha_D)
        cand_p = Point(x=x_new, y=y_new, s=s_new, mu=mu_new, beta=beta_new)
        feas_after = self.is_feasible(cand_p, pars.ls.comp_feas)

        # --- candidate cache -------------------------------------
        jt_y_new = jt_y_old + _c(alpha_D) * jt_dy
        fval_new = nlp.f(x_new, st.pdata)
        cand_c = Cache(fval=fval_new, cons=cons_new, a=a_new, g=g_new,
                       jt_y=jt_y_new, jt_ones=jt_ones_new)
        nan_any = nan_move | _isbad(g_new) | ~torch.isfinite(fval_new)

        # --- acceptance ------------------------------------------
        ls_mode = pars.ls.ls_mode_stable
        actual_red = self.merit_diff(p, cache, cand_p, cand_c)
        frac = actual_red / (predict_red * alpha)
        stable_ok = ((predict_red < 0.0) & (actual_red <= 0.0)
                     & (frac > pars.ls.predict_reduction_factor))
        if ls_mode in ("accept_filter", "accept_kkt"):
            filter_ok = self._filter_ok(st, cand_p, cand_c, y_new, mu_new,
                                        alpha)
        if ls_mode == "accept_filter":
            stb_accept = stable_ok | filter_ok
        elif ls_mode == "accept_stable":
            stb_accept = stable_ok
        elif ls_mode == "accept_kkt":
            stb_accept = filter_ok
        elif ls_mode == "accept_comp":
            comp_pred = (p.s * p.y
                         + _c(alpha) * (direction.y * p.s + direction.s * p.y)
                         - _c(mu_new))
            stb_accept = _norm_inf(comp_pred) < 50.0 * p.mu
        else:
            raise ValueError(f"ls_mode_stable {ls_mode}")

        # f32-endgame precision guard (config.py ls.precision_guard)
        pg = pars.ls.precision_guard
        if pg == "on" or (pg == "auto" and self.dtype != torch.float64):
            eps_dt = float(torch.finfo(self.dtype).eps)
            cur_merit_pg = self.eval_merit(p, cache)
            noise = (pars.ls.precision_guard_factor * eps_dt
                     * (1.0 + cur_merit_pg.abs()))
            below_noise = predict_red.abs() * alpha < noise
            kkt_cur = _norm_inf(self.grad_lag(cache, p.y, p.mu))
            kkt_cand_pg = _norm_inf(self.grad_lag(cand_c, y_new, mu_new))
            if pars.ls.kkt_include_comp:
                kkt_cur = kkt_cur + _norm_inf(self.comp(p))
                kkt_cand_pg = kkt_cand_pg + _norm_inf(self.comp(cand_p))
            guard_ok = below_noise & (kkt_cand_pg <= kkt_cur * (1.0 + 1e-3))
            stb_accept = stb_accept | guard_ok

        # aggressive acceptance (agg_ls.jl:36-48)
        sdf_cand = self.scaled_dual_feas(cand_p, cand_c, mu_new)
        apf = pars.agg_protection_factor
        tau = mu_new / (sdf_cand * (1.0 - apf))
        agg_accept = (mu_new / p.mu >= 1.0 - apf) | (tau >= 1.0)
        agg_suggest = torch.clamp(alpha * tau ** 2, min=apf ** 2)

        accept = torch.where(be_agg, agg_accept, stb_accept)
        accept = accept & dual_ok & feas_after & ~nan_any

        def code(v):
            return torch.full_like(accept, v, dtype=INT)

        status = torch.where(
            accept, code(LS_SUCCESS),
            torch.where(nan_any, code(LS_NAN_ERR),
                        torch.where(~dual_ok | ~feas_after,
                                    code(LS_DUAL_INFEASIBLE),
                                    code(LS_NOT_ENOUGH_PROGRESS))))
        bt = alpha * pars.ls.backtracking_factor
        suggested = torch.where(be_agg & (status == LS_NOT_ENOUGH_PROGRESS),
                                agg_suggest, bt)
        return status, suggested, cand_p, cand_c, alpha_D

    # ==================================================================
    # line search (reference: line_search.jl:36-199)
    # ==================================================================
    def _trial(self, st, direction, be_agg, alpha, lb_s_vec, lb_y_vec,
               predict_red):
        """One backtracking trial for every instance: (status, suggested
        alpha, candidate point, candidate cache, alpha_D).  The slack-bound
        rejection and the full evaluation are both computed and selected
        per instance (the JAX `lax.cond` under vmap)."""
        nlp = self.nlp
        p = st.p
        x_new = p.x + direction.x * _c(alpha)
        # --- move_primal (move.jl:2-22) + the J^T products the dual step
        # needs, from one forward pass of c at x_new
        wc_y, bnd_y = nlp.split_canonical(p.y)
        wc_dy, bnd_dy = nlp.split_canonical(direction.y)
        bnd1 = nlp._bnd_ones.to(self.dtype)
        if nlp.m_orig > 0:
            wc1 = nlp._wc_ones.to(self.dtype).expand_as(wc_y)
            cons_new, (jy, jdy, j1) = nlp.c_jtprod(
                x_new, [wc_y, wc_dy, wc1], st.pdata)
            jt_new = (jy + bnd_y, jdy + bnd_dy, j1 + bnd1)
        else:
            cons_new = torch.zeros(x_new.shape[0], 0, dtype=self.dtype,
                                   device=self.device)
            jt_new = (bnd_y, bnd_dy, bnd1.expand_as(bnd_y))
        a_new = nlp.a_of(x_new, cons_new, st.bvals)
        beta_new = p.beta + direction.beta * alpha
        s_new = a_new - _c(beta_new) * st.r0
        mu_new = p.mu + direction.mu * alpha
        nan_move = _isbad(a_new)
        s_ok = (s_new >= lb_s_vec).all(-1) & ~nan_move

        tstat, sugg, cp, cc, aD = self._trial_tail(
            st, direction, be_agg, alpha, x_new, cons_new, jt_new, a_new,
            beta_new, s_new, mu_new, nan_move, lb_y_vec, predict_red)
        # slack check failed: reject (status, backtrack, no candidate)
        rej = torch.where(nan_move, torch.full_like(tstat, LS_NAN_ERR),
                          torch.full_like(tstat, LS_S_BOUND))
        tstat = torch.where(s_ok, tstat, rej)
        sugg = torch.where(s_ok, sugg, alpha * self.pars.ls.backtracking_factor)
        cp = tree_select(s_ok, cp, p)
        cc = tree_select(s_ok, cc, st.cache)
        aD = torch.where(s_ok, aD, torch.zeros_like(aD))
        return tstat, sugg, cp, cc, aD

    def line_search(self, st: State, direction: Dir, be_agg, min_step_size,
                    active):
        """Backtracking LS with nonlinear slack update and dual LS.
        Returns (accepted, new Point, new Cache, LSInfo); only the
        instances in `active` take backtracking trips."""
        nlp = self.nlp
        pars = self.pars
        p, cache = st.p, st.cache
        th = pars.a_norm_penalty

        lb_sp = self.lb_s_predict(p.s, direction.x)
        alpha0 = self.simple_max_step(p.s, direction.s, lb_sp)
        lb_s_vec = self.lb_s(p.s, direction.x)
        lb_y_vec = self.lb_y(p.y, direction.x)

        # --- do_ls preconditions -------------------------------------
        jt_mus = nlp.jtprod(p.x, _c(p.mu) / p.s, st.pdata)
        grad_phi = cache.g - jt_mus + _c(p.mu * th) * cache.jt_ones
        gdx = (grad_phi * direction.x).sum(-1)
        ls_mode = pars.ls.ls_mode_stable
        comp_merit = _norm_inf(self.comp(p)) ** 3 / p.mu ** 2
        if ls_mode in ("accept_stable", "accept_kkt"):
            # merit_function_predicted_reduction(iter, dir, 1.0)
            jdx_c = nlp.jprod(p.x, direction.x, st.pdata)
            j_gain = (jdx_c ** 2 * (p.y / p.s)).sum(-1)
            hdx = self.fact_hmul(st.fact, direction.x)
            phi_red = gdx + 0.5 * ((direction.x * hdx).sum(-1) + j_gain)
            comp_pred1 = (p.s * p.y + direction.y * p.s + direction.s * p.y
                          - _c(p.mu + direction.mu))
            predict_red = phi_red + (_norm_inf(comp_pred1) ** 3
                                     - _norm_inf(self.comp(p)) ** 3) / p.mu ** 2
        else:
            predict_red = (-comp_merit + 0.5 * (
                gdx - st.delta * (direction.x ** 2).sum(-1)))
        if ls_mode == "accept_filter":
            do_ls_stb = gdx < 0.0
        elif ls_mode == "accept_stable":
            do_ls_stb = predict_red < 0.0
        else:
            do_ls_stb = torch.ones_like(gdx, dtype=torch.bool)

        # aggressive (Class_agg_ls, agg_ls.jl:9-33)
        eta_probe = -direction.mu / p.mu
        gam = 1.0 - eta_probe
        r_P = cache.a - p.s
        y_tilde = (_c(gam * p.mu) - _c(eta_probe) * p.y * r_P) / p.s
        jt_yt = nlp.jtprod(p.x, y_tilde, st.pdata)
        grad_lag_t = cache.g - jt_yt + _c(p.mu * gam * th) * cache.jt_ones
        do_ls_agg = (grad_lag_t * direction.x).sum(-1) < 0.0

        do_ls = torch.where(be_agg, do_ls_agg, do_ls_stb)
        dir_bad = _isbad(direction.x) | _isbad(direction.y) | _isbad(direction.s)
        do_ls = do_ls & ~dir_bad

        B = alpha0.shape[0]
        alpha = alpha0
        i = torch.zeros(B, dtype=INT, device=self.device)
        status = torch.full((B,), LS_NONE, dtype=INT, device=self.device)
        alpha_D = torch.zeros_like(alpha0)
        cp, cc = p, cache
        searching = do_ls & active
        while True:
            running = (searching & (status != LS_SUCCESS)
                       & (status != LS_MIN_ALPHA) & (i < pars.ls.num_backtracks))
            if not self._any(running):
                break
            below = alpha < min_step_size
            tstat, sugg, tp, tc, aD = self._trial(
                st, direction, be_agg, alpha, lb_s_vec, lb_y_vec, predict_red)
            run = running & ~below
            # keep the ACCEPTED alpha on success
            next_alpha = torch.where(tstat == LS_SUCCESS, alpha, sugg)
            alpha = torch.where(run, next_alpha, alpha)
            i = i + run.to(INT)
            status = torch.where(run, tstat, torch.where(
                running & below, torch.full_like(status, LS_MIN_ALPHA),
                status))
            alpha_D = torch.where(run, aD, alpha_D)
            cp = tree_select(run, tp, cp)
            cc = tree_select(run, tc, cc)

        unfinished = ((status != LS_SUCCESS) & (status != LS_MIN_ALPHA)
                      & (status != LS_PREDICT_RED_NON_NEG))
        status = torch.where(do_ls & unfinished,
                             torch.full_like(status, LS_MAX_LS_IT), status)
        status = torch.where(do_ls, status,
                             torch.full_like(status, LS_PREDICT_RED_NON_NEG))
        accepted = status == LS_SUCCESS
        info = LSInfo(status=status, alpha_P=alpha, alpha_D=alpha_D,
                      num_steps=i)
        return accepted, cp, cc, info

    # ==================================================================
    # take_step (reference: take_step.jl:34-75 + probe :2-17)
    # ==================================================================
    def take_step(self, st: State, be_agg, active):
        """One direction + line search.  Returns (accepted, new_p, new_c,
        LSInfo, Dir, kkt_ratio, eta (B, 3))."""
        pars = self.pars
        p, cache = st.p, st.cache
        B = p.mu.shape[0]
        dt = self.dtype

        # aggressive factors: Mehrotra probe (affine direction, max step)
        z = self._full((B,), 0.0)
        adir, _ = self.compute_direction(st.fact, p, cache, z, z, z,
                                         st.pdata)
        lb_sp = self.lb_s_predict(p.s, adir.x)
        a_s = self.simple_max_step(p.s, adir.s, lb_sp)
        a_y = self.simple_max_step(p.y, adir.y, torch.zeros_like(p.y))
        sigma = torch.minimum(a_s, a_y)
        gamma = torch.clamp((1.0 - sigma) ** 2, max=0.5)
        if pars.ls.agg_gamma == "mehrotra":
            e_agg = torch.stack([gamma, gamma, gamma], -1)
        elif pars.ls.agg_gamma == "mehrotra_stb":
            e_agg = torch.stack([gamma, z, gamma], -1)
        elif pars.ls.agg_gamma == "affine":
            e_agg = self._full((B, 3), 0.0)
        else:  # constant
            e_agg = torch.tensor([0.2, 0.0, 0.2], dtype=dt,
                                 device=self.device).expand(B, 3)
        r_P = cache.a - p.s
        ms_agg = pars.ls.min_step_size_agg_ratio * torch.clamp(
            1.0 / (-r_P / p.s).amax(-1), max=1.0)
        # stabilization factors
        e_stb = torch.tensor([1.0, 0.0, 1.0], dtype=dt,
                             device=self.device).expand(B, 3)
        eta = torch.where(be_agg[:, None], e_agg, e_stb)
        min_step = torch.where(be_agg, ms_agg,
                               self._full((B,), pars.ls.min_step_size_stable))

        direction, ratio = self.compute_direction(
            st.fact, p, cache, eta[:, 0], eta[:, 1], eta[:, 2], st.pdata)
        accepted, cand_p, cand_c, info = self.line_search(
            st, direction, be_agg, min_step, active)
        return accepted, cand_p, cand_c, info, direction, ratio, eta

    # ==================================================================
    # switching condition (reference: one_phase.jl:91-108)
    # ==================================================================
    def switching_condition(self, st: State):
        pars = self.pars
        p, cache = st.p, st.cache
        is_feas = self.is_feasible(p, pars.ls.comp_feas_agg)
        dual_avg = self.scaled_dual_feas(p, cache, p.mu)
        if pars.primal_bounds_dual_feas:
            prog = dual_avg < pars.aggressive_dual_threshold * _norm_inf(
                cache.a - p.s)
        else:
            prog = dual_avg < pars.aggressive_dual_threshold * p.mu
        th = pars.a_norm_penalty
        lag_grad = (_norm1(self.grad_lag(cache, p.y, p.mu))
                    < (p.s * p.y).sum(-1)
                    + _norm1(cache.g + _c(p.mu * th) * cache.jt_ones))
        be = is_feas & prog & lag_grad
        return be | (st.last_superlinear & prog & lag_grad)

    # ==================================================================
    # termination (reference: terminate.jl:3-23)
    # ==================================================================
    def terminate(self, p: Point, cache: Cache, bvals=None, pdata=None):
        if self.pars.kkt.residual_precision == "f64":
            return self.terminate_f64(p, cache, bvals, pdata)
        scale = self.dual_scale(p.y, p.s)
        sdf0 = _norm_inf(cache.g - cache.jt_y) * scale
        comp_scaled = (p.s * p.y).amax(-1) * scale
        max_vio = -torch.clamp(cache.a.amin(-1), max=0.0)
        jt_y_1 = _norm1(cache.jt_y)
        feas_obj = -(cache.a * p.y).sum(-1)
        fark1 = torch.where(feas_obj > 0.0, jt_y_1 / feas_obj,
                            torch.full_like(feas_obj, float("inf")))
        fark2 = (jt_y_1 + (p.s * p.y).sum(-1)) / _norm1(p.y)
        return self._term_verdict(p, cache, sdf0, comp_scaled, max_vio,
                                  fark1, fark2)

    def terminate_f64(self, p: Point, cache: Cache, bvals=None,
                      pdata=None):
        """Termination with every measured quantity evaluated by float64
        oracles (`kkt.residual_precision="f64"`, and the between-chunk
        batch recheck of parallel/batch.py)."""
        f64 = torch.float64
        dt = self.dtype
        scale = self.dual_scale(p.y, p.s)
        gl64 = self.nlp.grad_lag_hi(p.x, p.y, 0.0, pdata)
        sdf0 = (_norm_inf(gl64) * scale.to(f64)).to(dt)
        sy64 = p.s.to(f64) * p.y.to(f64)
        comp_scaled = (sy64.amax(-1) * scale.to(f64)).to(dt)
        a64 = self.nlp.a_of_hi(p.x, bvals, pdata)
        max_vio = (-torch.clamp(a64.amin(-1), max=0.0)).to(dt)
        y64 = p.y.to(f64)
        jt_y_1 = _norm1(self.nlp.jtprod_hi(p.x, p.y, pdata))
        feas_obj = -(a64 * y64).sum(-1)
        fark1 = torch.where(feas_obj > 0.0, jt_y_1 / feas_obj,
                            torch.full_like(feas_obj, float("inf"))).to(dt)
        fark2 = ((jt_y_1 + (p.s.to(f64) * y64).sum(-1))
                 / _norm1(y64)).to(dt)
        return self._term_verdict(p, cache, sdf0, comp_scaled, max_vio,
                                  fark1, fark2)

    def _term_verdict(self, p, cache, sdf0, comp_scaled, max_vio,
                      fark1, fark2):
        pars = self.pars
        tol = pars.term.tol_opt
        optimal = (sdf0 < tol) & (comp_scaled < tol) & (max_vio < tol)
        infeas = ((max_vio > tol) & (fark1 < pars.term.tol_inf_1)
                  & (fark2 < pars.term.tol_inf_2))
        unbounded = _norm_inf(p.x) > 1.0 / pars.term.tol_unbounded
        maxgrad = _norm_inf(cache.g) > pars.term.grad_max
        out = torch.full(optimal.shape, RUNNING, dtype=INT, device=self.device)
        for flag, code in ((maxgrad, MAX_GRADIENT),
                           (unbounded, DUAL_INFEASIBLE),
                           (infeas, PRIMAL_INFEASIBLE), (optimal, OPTIMAL)):
            out = torch.where(flag, torch.full_like(out, code), out)
        return out

    # ==================================================================
    # filter bookkeeping (reference: filter_ls.jl:44-75)
    # ==================================================================
    def filter_add(self, st: State) -> Filter:
        p, cache = st.p, st.cache
        pars = self.pars
        merit = self.eval_merit(p, cache)
        kkt = _norm_inf(self.grad_lag(cache, p.y, p.mu))
        if pars.ls.kkt_include_comp:
            kkt = kkt + _norm_inf(self.comp(p))
        kkt = kkt * self.dual_scale(p.y, p.s)
        f = st.filt
        i = torch.clamp(f.count, max=self.filt_cap - 1)
        slot = (torch.arange(self.filt_cap, device=self.device)[None, :]
                == i[:, None].long())
        return Filter(merit=torch.where(slot, _c(merit), f.merit),
                      kkt=torch.where(slot, _c(kkt), f.kkt),
                      beta=torch.where(slot, _c(p.beta), f.beta),
                      count=torch.clamp(f.count + 1, max=self.filt_cap))

    # ==================================================================
    # one inner step (correction i of outer iteration t)
    # ==================================================================
    def _on_fail(self, st_c: State, old_delta, direction, ratio, eta, info):
        """Failed step attempt: escalate delta and re-factor at the factor
        point (one_phase.jl:221-258).  Returns (state, dead)."""
        pars = self.pars
        delta = st_c.delta
        can_escalate = delta < self.delta_max
        gl = _norm_inf(self.grad_lag(st_c.cache, st_c.p.y, st_c.p.mu))
        dxn = _norm_inf(direction.x)
        q = gl / dxn
        lag_term = torch.where((dxn > 0) & torch.isfinite(q), q,
                               torch.zeros_like(q))
        if pars.delta.lag_cap != float("inf"):
            lag_term = torch.minimum(
                lag_term, pars.delta.lag_cap
                * torch.clamp(delta, min=pars.delta.start))
        base = torch.maximum(delta * pars.delta.inc, torch.clamp(
            old_delta * pars.delta.dec, min=pars.delta.start))
        if pars.test.response_to_failure == "lag_delta_inc":
            nd = torch.maximum(lag_term, base)
        else:
            nd = base
        nd = torch.where(can_escalate, nd, delta)
        (Lc, Dc), okc = self.factor(self._fact_q(st_c.fact), nd,
                                    st_c.fact.rescale, fact=st_c.fact)
        Lc = self.finalize_solver(Lc)
        fact = st_c.fact._replace(L=tree_select(okc, Lc, st_c.fact.L),
                                  D=tree_select(okc, Dc, st_c.fact.D),
                                  delta=nd)
        st2 = st_c._replace(delta=nd, fact=fact,
                            tot_num_fac=st_c.tot_num_fac + 1,
                            cum_fac=st_c.cum_fac + 1,
                            dir=direction, kkt_ratio=ratio, eta=eta, ls=info)
        return st2, ~can_escalate

    def _attempt_phase(self, st: State, be_agg, old_delta, active):
        """Step attempts with delta escalation (one_phase.jl:221-258) for
        the instances in `active`, then the last-resort dual reset."""
        pars = self.pars
        B = active.shape[0]
        acc = torch.zeros(B, dtype=torch.bool, device=self.device)
        dead = torch.zeros_like(acc)
        k = torch.zeros(B, dtype=INT, device=self.device)
        st_c = st
        while True:
            trip = active & ~acc & ~dead & (k < pars.max_step_attempts)
            accepted, cand_p, cand_c, info, direction, ratio, eta = \
                self.take_step(st_c, be_agg, trip)
            took = trip & accepted
            st_acc = st_c._replace(p=cand_p, cache=cand_c, dir=direction,
                                   kkt_ratio=ratio, eta=eta, ls=info)
            failed = trip & ~accepted
            if not self._any(failed):
                st_c = tree_select(took, st_acc, st_c)
                acc = acc | took
                k = k + trip.to(INT)
                break
            st_fail, dead2 = self._on_fail(st_c, old_delta, direction, ratio,
                                           eta, info)
            st_c = tree_select(took, st_acc, tree_select(failed, st_fail, st_c))
            acc = acc | took
            dead = torch.where(failed, dead2, dead)
            k = k + trip.to(INT)

        # last resort (one_phase.jl:243-247): delta at max -> reset the
        # duals y = mu / s if comp is nonzero, else MAX_DELTA
        comp_big = _norm_inf(self.comp(st_c.p)) > 1e-14
        y_new = _c(st_c.p.mu) / st_c.p.s
        st_reset = st_c._replace(
            p=st_c.p._replace(y=y_new),
            cache=st_c.cache._replace(jt_y=self.nlp.jtprod(
                st_c.p.x, y_new, st_c.pdata)),
            step_ok=torch.ones_like(acc))
        st_dead = st_c._replace(
            status=torch.full_like(st_c.status, MAX_DELTA),
            step_ok=torch.zeros_like(acc))
        last = tree_select(comp_big, st_reset, st_dead)
        return tree_select(dead & ~acc, last, st_c._replace(step_ok=acc))

    def inner_step(self, st: State, first: bool, do) -> State:
        """reference: one_phase.jl:174-281 body.  `do` marks the instances
        whose result is kept (the caller selects)."""
        pars = self.pars
        be_agg = self.switching_condition(st)
        st = st._replace(last_superlinear=torch.zeros_like(be_agg))

        if first:
            # -- factor at current point -------------------------------
            fact = self.form_factor(st.p, st.cache, st.fact, st.pdata)
            success, nfac_inertia, new_delta, LD = self.ipopt_strategy(
                fact, st.delta, active=do)
            # on the dense path the freshly-formed Q was a temporary of the
            # factor search
            fact = fact._replace(L=self.finalize_solver(LD[0]), D=LD[1],
                                 delta=new_delta, ok=success,
                                 Q=self._store_q(fact.Q))
            old_delta = st.delta
            st = st._replace(fact=fact, delta=new_delta,
                             num_fac_inertia=nfac_inertia,
                             tot_num_fac=nfac_inertia,
                             cum_fac=st.cum_fac + nfac_inertia)
            st_att = self._attempt_phase(st, be_agg, old_delta, do & success)
            st = tree_select(success, st_att, st._replace(
                status=torch.full_like(st.status, MAX_DELTA)))
        else:
            # corrections: reuse the factorization (one_phase.jl:262-279)
            accepted, cand_p, cand_c, info, direction, ratio, eta = \
                self.take_step(st, be_agg, do)
            st_acc = st._replace(p=cand_p, cache=cand_c, dir=direction,
                                 kkt_ratio=ratio, eta=eta, ls=info,
                                 step_ok=torch.ones_like(accepted))
            if pars.superlinear_theory_mode:
                st_acc = st_acc._replace(
                    last_superlinear=be_agg & (cand_p.mu < st.p.mu * 0.1))
            st_fail = st._replace(dir=direction, kkt_ratio=ratio, eta=eta,
                                  ls=info, step_ok=torch.zeros_like(accepted))
            st = tree_select(accepted, st_acc, st_fail)

        # filter update + termination + history (one_phase.jl:288-321)
        st = st._replace(filt=self.filter_add(st), agg_mask=be_agg)
        new_status = self.terminate(st.p, st.cache, st.bvals, st.pdata)
        st = st._replace(status=torch.where(st.status == RUNNING, new_status,
                                            st.status))
        step_type = torch.where(be_agg, STEP_AGG, STEP_STB)
        return st._replace(hist=hist_mod.record(self, st, step_type))

    # ==================================================================
    # outer iteration + chunk runner
    # ==================================================================
    def outer_iter(self, st: State, active) -> State:
        """One outer iteration for the instances in `active` (the others
        are returned unchanged)."""
        for i in range(self.pars.max_it_corrections):
            first = i == 0
            do = active & (st.status == RUNNING)
            if not first:
                do = do & st.step_ok
            st = tree_select(do, self.inner_step(st, first, do), st)
        term = self.pars.term
        new = st
        if term.stall_patience > 0 or term.unbounded_ray_patience > 0:
            # shared no-progress tracker (stall exit + recession ray)
            prog = st.p.mu - torch.clamp(st.cache.a.amin(-1), max=0.0)
            improved = prog < st.best_prog * (1.0 - term.stall_rtol)
            new = new._replace(
                best_prog=torch.where(improved, prog, st.best_prog),
                last_prog_t=torch.where(improved, st.t, st.last_prog_t))
        status = new.status
        since = new.t - new.last_prog_t if new.last_prog_t is not None \
            else None
        if term.unbounded_ray_patience > 0:
            max_vio = -torch.clamp(new.cache.a.amin(-1), max=0.0)
            ray = ((status == RUNNING)
                   & (since >= term.unbounded_ray_patience)
                   & (_norm_inf(new.p.x) > term.unbounded_ray_norm)
                   & (max_vio < term.tol_inf_1))
            status = torch.where(ray, torch.full_like(status, DUAL_INFEASIBLE),
                                 status)
        if term.stall_patience > 0:
            stalled = (status == RUNNING) & (since >= term.stall_patience)
            status = torch.where(stalled, torch.full_like(status, STALLED),
                                 status)
        new = new._replace(status=status, t=new.t + 1)
        return tree_select(active, new, st)

    def _run_chunk(self, st: State) -> State:
        with _mm_precision_ctx(self.pars.matmul_precision):
            pars = self.pars
            for _ in range(pars.chunk_size):
                active = (st.status == RUNNING) & (st.t <= pars.term.max_it)
                if not self._any(active):
                    break
                st = self.outer_iter(st, active)
            over = (st.status == RUNNING) & (st.t > pars.term.max_it)
            return st._replace(status=torch.where(
                over, torch.full_like(st.status, MAX_IT), st.status))

    # ==================================================================
    # initialization (reference: src/init/gertz_init.jl)
    # ==================================================================
    def project_bounds(self, x0, bvals):
        """Ipopt-style projection into bounds (primal-project.jl:1-68),
        with the (B, k) bound values scattered over the finite-bound
        pattern."""
        nlp = self.nlp
        B = x0.shape[0]
        j = nlp._j
        lv = self._full((B, self.n), -float("inf"))
        uv = self._full((B, self.n), float("inf"))
        lv[:, j["lvi"]] = bvals["lv"].expand(B, -1)
        uv[:, j["uvi"]] = bvals["uv"].expand(B, -1)
        k1 = 1e-2
        k2 = 1e-2
        p_L = torch.minimum(k1 * torch.clamp(lv.abs(), min=1.0), k2 * (uv - lv))
        p_U = torch.minimum(k1 * torch.clamp(uv.abs(), min=1.0), k2 * (uv - lv))
        b_L = torch.where(torch.isfinite(lv), lv + p_L, lv)
        b_U = torch.where(torch.isfinite(uv), uv - p_U, uv)
        return torch.minimum(torch.maximum(x0, b_L), b_U)

    def _initial_state(self, x0, bvals=None, pdata=None) -> State:
        nlp, pars = self.nlp, self.pars
        dt = self.dtype
        m = self.m
        mc = nlp.m_cons  # canonical rows from original constraints ("ais")
        x0 = x0.to(dtype=dt, device=self.device)
        B = x0.shape[0]
        if bvals is None:
            bvals = {k: v.expand(B, -1) for k, v in nlp.default_bvals().items()}
        if pdata is None:
            # the template's data, one copy per instance (a parametric
            # batch carries its own)
            pdata = ({k: v.expand(B, *v.shape)
                      for k, v in nlp._pdata0.items()}
                     if nlp.parametric else {})
        x = (self.project_bounds(x0, bvals)
             if pars.init.start_satisfying_bounds else x0)

        y0 = self._full((B, m), 1.0)
        cons = nlp.c(x, pdata)
        a = nlp.a_of(x, cons, bvals)
        g = nlp.grad_f(x, pdata)

        d_s = torch.clamp(-2.0 * a.amin(-1), min=1e-4)
        s0 = a + _c(d_s)
        p0 = Point(x=x, y=y0, s=s0, mu=d_s, beta=self._full((B,), 1.0))
        cache0 = self.make_cache(x, y0, bvals, pdata)

        empty_fact = self._empty_factor(B)
        if self._param_const_jac or self._param_const_hess:
            # parametric constant structure: evaluated once per solve; the
            # Factor carries it through every iteration (form_factor)
            empty_fact = empty_fact._replace(
                Jc=(nlp.jac_orig(x, pdata).contiguous()
                    if self._param_const_jac else empty_fact.Jc),
                H=(nlp.lag_hess(x, self._full((B, m), 0.0), pdata)
                   .contiguous()
                   if self._param_const_hess else empty_fact.H))
        z = self._full((B,), 0.0)
        if pars.init.init_style == "gertz":
            # one full KKT cycle at the guarded start (gertz_init.jl:22-28)
            fact = self.form_factor(p0, cache0, empty_fact, pdata)
            succ, nfac, delta0, LD = self.ipopt_strategy(fact, z)
            fact = fact._replace(L=self.finalize_solver(LD[0]), D=LD[1],
                                 delta=delta0, ok=succ)
            adir, _ = self.compute_direction(fact, p0, cache0, z, z, z,
                                             pdata)
            y_t = y0 + adir.y
            s_t = torch.cat([-a[:, :mc], a[:, mc:]], -1)  # bound rows keep a_i
        else:
            y_t, s_t, fact, succ, nfac = self._mehrotra_start(
                x, a, g, p0, cache0, empty_fact, pdata)

        if mc > 0:
            min_s_cons = s_t[:, :mc].amin(-1)
        else:
            min_s_cons = z
        d_s2 = (torch.clamp(-2.0 * min_s_cons, min=0.0)
                + _norm_inf(g - nlp.jtprod(x, y_t, pdata))
                / (1.0 + _norm_inf(y_t)))
        d_y = torch.clamp(-2.0 * y_t.amin(-1), min=0.0)
        s_t = torch.cat([s_t[:, :mc] + _c(d_s2 + 1e-8), s_t[:, mc:]], -1)
        y_t = y_t + _c(d_y)
        d_y_t = d_y + 0.5 * (s_t * y_t).sum(-1) / s_t.sum(-1)
        y_t = y_t + _c(d_y_t)
        y_t = torch.clamp(y_t, pars.init.dual_min, pars.init.dual_max)
        d_s_t = d_s2 + 0.5 * (s_t * y_t).sum(-1) / y_t.sum(-1)
        s_t = torch.cat([s_t[:, :mc] + _c(d_s_t), s_t[:, mc:]], -1)

        # correct_guess3 (correct-guess.jl:94-132)
        mehrotra = pars.init.init_style == "mehrotra"
        if mehrotra and not pars.init.mehotra_scaling:
            mu = 1e-6 + _norm_inf(s_t) + _norm_inf(g)
            conW = self._full((B, m), 0.0)
            conW[:, :mc] = 1.0
        else:
            mu = (s_t * y_t).mean(-1)
            conW = (s_t - a) / _c(mu)
        if mehrotra:
            # per-class constraint weights (init.jl:19-85); defaults 1.0
            lin, eqb = nlp.lin_mask, nlp.eqbound_mask
            scale_vec = np.ones(m)
            scale_vec[eqb & ~lin] *= pars.init.nl_eq_scale
            scale_vec[~eqb & ~lin] *= pars.init.nl_ineq_scale
            scale_vec[lin] *= pars.init.linear_scale
            conW = conW * torch.as_tensor(scale_vec, dtype=dt,
                                          device=self.device)
        s = a + _c(mu) * conW
        mu = mu * pars.init.mu_scale

        # center_dual! with comp_feas_agg (gertz_init.jl:44-49)
        cfa = pars.ls.comp_feas_agg
        y_c = _c(mu) / s
        y = torch.minimum(y_c / cfa, torch.maximum(y_t, cfa * y_c))

        p = Point(x=x, y=y, s=s, mu=mu, beta=self._full((B,), 1.0))
        cache = self.make_cache(x, y, bvals, pdata)
        r0 = cache.a - s
        fact = fact._replace(Q=self._store_q(fact.Q))

        def ints(v):
            return torch.full((B,), v, dtype=INT, device=self.device)

        def bools(v):
            return torch.full((B,), v, dtype=torch.bool, device=self.device)

        inf = float("inf")
        filt = Filter(merit=self._full((B, self.filt_cap), inf),
                      kkt=self._full((B, self.filt_cap), inf),
                      beta=self._full((B, self.filt_cap), inf),
                      count=ints(0))
        hist = History(buf=self._full((B, self.hist_cap, hist_mod.NCOLS), 0.0),
                       count=ints(0))
        zdir = Dir(x=torch.zeros_like(x), y=torch.zeros_like(y),
                   s=torch.zeros_like(s), mu=z, beta=z)
        ls0 = LSInfo(status=ints(LS_NONE), alpha_P=z, alpha_D=z,
                     num_steps=ints(0))
        track = (pars.term.stall_patience > 0
                 or pars.term.unbounded_ray_patience > 0)
        st = State(p=p, cache=cache, fact=fact, dir=zdir, filt=filt, hist=hist,
                   r0=r0, delta=z, t=ints(1), status=ints(RUNNING),
                   step_ok=bools(True), last_superlinear=bools(False),
                   kkt_ratio=z, eta=self._full((B, 3), 0.0), ls=ls0,
                   agg_mask=bools(False), num_fac_inertia=ints(0),
                   tot_num_fac=ints(0), cum_fac=nfac, bvals=bvals, pdata=pdata,
                   best_prog=self._full((B,), inf) if track else None,
                   last_prog_t=ints(0) if track else None)
        # init factorization failure -> MAX_DELTA (reference errors out)
        status = torch.where(succ, ints(RUNNING), ints(MAX_DELTA))
        status = torch.where(status == RUNNING,
                             self.terminate(p, cache, bvals, pdata), status)
        st = st._replace(status=status)
        return st._replace(hist=hist_mod.record(self, st, STEP_IT0))

    def _mehrotra_start(self, x, a, g, p0, cache0, empty_fact, pdata):
        """The Mehrotra init's dual estimate and first factor
        (onephase_tpu/ipm/core.py:1835-1855): y from the ridge least
        squares (lam I + J^T J) dx = -g, y = -J dx (estimate_y_tilde,
        guess-vars.jl:128-169), s = a, and one factorization at
        delta.start.  Returns (y_t, s_t, fact, succ, nfac)."""
        nlp, pars = self.nlp, self.pars
        B, n, m = x.shape[0], self.n, self.m
        Jc0 = nlp.jac_orig(x, pdata)
        lam = 1e-4
        Hr = (lam * torch.eye(n, dtype=self.dtype, device=self.device)
              + nlp.jtdj(Jc0, self._full((B, m), 1.0)))
        # jnp.linalg.cholesky fills NaN where the factorization fails, which
        # the reference's bad-estimate guard catches; cholesky_ex reports
        # it through LAPACK's info instead
        Lr, info = torch.linalg.cholesky_ex(Hr)
        zr = torch.linalg.solve_triangular(Lr, -g.unsqueeze(-1), upper=False)
        dx0 = torch.linalg.solve_triangular(Lr.transpose(-1, -2), zr,
                                            upper=True).squeeze(-1)
        y_t = -nlp.jprod_mat(Jc0, dx0)
        bad = _isbad(y_t) | (info != 0)
        y_t = torch.where(bad[:, None], torch.ones_like(y_t), y_t)
        fact = self.form_factor(p0, cache0, empty_fact, pdata)
        delta0 = self._full((B,), pars.delta.start)
        LD0, succ = self.factor(fact.Q, delta0, fact.rescale, fact=fact)
        fact = fact._replace(L=self.finalize_solver(LD0[0]), D=LD0[1],
                             delta=delta0, ok=succ)
        nfac = torch.ones(B, dtype=INT, device=self.device)
        return y_t, a, fact, succ, nfac

    def _empty_factor(self, B) -> Factor:
        """The factor before the first factorization: (n + mr) square on
        the symmetric paths, with a unit rescale where one is carried."""
        n, m = self.n, self.m
        dt = self.dtype
        N = n + self.mr if self.kkt_type in SYMMETRIC else n
        rescale = (self._full((B, N), 1.0)
                   if (self.kkt_type == "clever_symmetric"
                       and self.pars.kkt.kkt_system_rescale != "none")
                   else None)
        Jc = torch.zeros(B, self.nlp.m_orig, n, dtype=dt, device=self.device)
        H = torch.zeros(B, n, n, dtype=dt, device=self.device)
        return Factor(Jc=self._store_jc(Jc), H=self._store_h(H), Q=None,
                      schur_diag=self._full((B, n), 0.0),
                      L=torch.eye(N, dtype=self.L_store_dtype,
                                  device=self.device).expand(B, N, N),
                      D=self._full((B, N), 1.0, self.factor_store_dtype),
                      delta=self._full((B,), 0.0),
                      s_f=self._full((B, m), 1.0), y_f=self._full((B, m), 1.0),
                      ok=torch.zeros(B, dtype=torch.bool, device=self.device),
                      rescale=rescale)
