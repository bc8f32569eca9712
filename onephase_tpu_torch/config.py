"""Hierarchical solver parameter tree.

TPU-native re-design of the reference's config system
(reference: src/parameters.jl:4-282 — `Class_parameters` with sub-structs
`term`, `init`, `delta`, `ls`, `kkt`, `test`).  Defaults match the reference
exactly so that iteration-for-iteration parity is achievable.

Overrides use string paths with either ``!`` (reference JuMP syntax,
src/JuMPinterface.jl:570-586) or ``.`` as separator, e.g.::

    pars = Params().with_overrides({"term!max_it": 100, "ls.dual_ls": 2})

Parameters are plain Python values (static under jit): changing them
triggers recompilation, which matches how they are used (per-campaign).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, fields, replace
from typing import Any, Dict


@dataclass(frozen=True)
class KKTParams:
    """KKT/linear-solver options (reference: src/parameters.jl:4-46)."""

    it_refine_num: int = 3            # fixed-count iterative refinement (schur.jl:158)
    it_refine_highprec: bool = False  # f64-compensated residual accumulation (ref: BigFloat)
    # adaptive refinement (TPU addition): keep refining until the Schur
    # residual drops below it_refine_tol * ||rhs|| (0 -> 10*eps of the solve
    # dtype) or it_refine_max passes, exiting early when converged; the
    # a-posteriori KKT-error ratio remains the outer guardrail.
    it_refine_adaptive: bool = False
    it_refine_tol: float = 0.0
    it_refine_max: int = 10
    # mixed-precision residuals (TPU addition; the reference is all-f64):
    #   same — residuals in the solve dtype
    #   f64  — dual residual (RHS + termination) and violation measured by
    #          f64 oracle evaluation while factorization/line-search stay in
    #          the solve dtype.  In f32 the oracle's own rounding floors the
    #          certifiable KKT error (see nlp.grad_lag_hi); this restores
    #          tol 1e-6 certification.  Requires jax_enable_x64.
    residual_precision: str = "same"
    # factor_precision (TPU addition, the converse of residual_precision;
    # schur path only — the symmetric paths refine against the stored K):
    #   same — factor in the solve dtype
    #   f32  — with an f64 solve dtype, run the whole preconditioner
    #          pipeline (Q = H + J'DJ formation AND Cholesky + backsolves —
    #          the 42.1% + 35.4% cost items, docs/one-phase.tex:901-912) in
    #          f32 on the MXU; iterative refinement against the f64
    #          residual (it_refine_*) recovers f64-accurate directions for
    #          cond(Q) << 1/eps32.  Classic mixed-precision IPM layout:
    #          state/oracles f64 (cheap, emulated on TPU), factorization
    #          f32 (fast, native).  vmap/batch friendly.
    #   f32_fallback — like f32, but Q is kept in f64 and any factorization
    #          whose f32 pivot check rejects (cond beyond ~1/eps32, e.g.
    #          the race to ||x|| -> 1/tol_unbounded for an unboundedness
    #          certificate) is redone in f64 under lax.cond.  Robust for
    #          single solves; under vmap both branches execute — prefer
    #          "f32" for batches.
    factor_precision: str = "same"
    # q_form_dtype (TPU addition; schur only):
    #   same — form Q = H + J'DJ in the factor dtype
    #   bf16 — run the rank-m update on the MXU in bf16 with f32
    #          accumulation (scale-split (sqrt(w)J)'(sqrt(w)J)).  The
    #          ~3e-3 relative error is absorbed by iterative refinement
    #          (the factor is a preconditioner; residuals use exact H/Jc).
    #          Profile-driven: Q formation is the 42.1% cost item and the
    #          MXU runs bf16 at ~4x f32 (results/profile_kernels_tpu.md).
    q_form_dtype: str = "same"
    # fallback_form_f32 (TPU addition; f32_fallback only): form AND carry
    # Q on the f32 MXU instead of in emulated f64.  The f32 factorization
    # attempt only ever consumed Q rounded to f32, so nothing is lost on
    # the hot path; the rare fallback branch re-forms the exact f64 Q from
    # the stored f64 J/H before the f64 Cholesky (lazily, inside the
    # lax.cond — reached only when the pivot screen rejects).  This moves
    # the 42.1% cost item (docs/one-phase.tex:901-912) off the TPU's
    # emulated-f64 path; measured on ECON250 in results/profile_econ_250.md.
    fallback_form_f32: bool = False
    # hi_matvec_f32pair (TPU addition; f64 solves on the schur path): run
    # the direction/refinement J-matvecs in f32 double-single pairs
    # (ops/refine.pair_matvec64) instead of emulated f64.  Relative error
    # ~1e-13 — beyond the 1e-12 refinement target — at ~10x less cost on
    # TPU, where every f64 op is software-emulated.  Profile-driven: the
    # direction solve was 3 x 143 ms = 82% of the 524 ms ECON250 outer
    # iteration (results/profile_econ_250.md).
    #   "off"; "refine" — pairs inside the refinement loop only
    #   (direction-level rhs/jdx/KKT-error products stay exact f64: the
    #   a-posteriori ratio guard is noise-sensitive at the endgame);
    #   "all" — pairs everywhere (fastest, costs ~15% more iterations
    #   on ECON50)
    hi_matvec_f32pair: str = "off"
    # precond_f32 (TPU addition; invchol/pallas backends, f64 solves): carry
    # the finalized solve operator M = Q^-1 in f32.  The backsolve is only
    # ever a preconditioner application (refinement supplies the accuracy),
    # so f32 M loses nothing while the M-matvec and the triangular-inverse
    # gram leave the emulated-f64 path.
    precond_f32: bool = False
    # schur | symmetric | clever_symmetric (reference default :schur), plus
    # TPU addition schur_dual: Woodbury/normal-equations factorization of
    # the (m_orig, m_orig) dual matrix for zero-Hessian LPs with m < n
    # (ipm/dual.py) — 8-16x fewer factorization flops at m = n/2
    kkt_solver_type: str = "schur"
    # chain_partitions (TPU addition; ChainKernel only): >1 factors the
    # block-tridiagonal Schur complement with that many parallel chunks
    # (nested dissection: interiors vmapped/mesh-shardable, tiny sequential
    # reduced system over separators; ops/block_tridiag.partitioned_factor).
    # 0/1 -> fully sequential K-step block recursion.
    chain_partitions: int = 0
    # xla: chol + triangular solves; invchol: chol + explicit-inverse matvec
    # solves; pallas: blocked Pallas chol + inverse (TPU).  (The reference's
    # julia/HSL/mumps backend selection, linear_system_solvers.jl:11-33.)
    linear_solver_type: str = "xla"
    kkt_system_rescale: str = "none"
    # relative pivot tolerance for the Cholesky inertia test: reject the
    # factorization when min(pivot)^2 <= tol * max(pivot)^2 (emulates sparse
    # CHOLMOD/MA97 failure on numerically singular systems, julia.jl:70-90)
    chol_pivot_tol: float = 1e-15


@dataclass(frozen=True)
class LineSearchParams:
    """Line-search parameters (reference: src/parameters.jl:48-104)."""

    kkt_reduction_factor: float = 0.2
    kkt_include_comp: bool = True
    filter_type: str = "test2"
    predict_reduction_factor: float = 0.1
    fraction_to_boundary: float = 0.1
    fraction_to_boundary_predict: float = 0.2
    fraction_to_boundary_linear: float = 0.1
    fraction_to_boundary_predict_exp: float = 0.5
    backtracking_factor: float = 0.5
    num_backtracks: int = 60
    agg_gamma: str = "mehrotra_stb"   # mehrotra | mehrotra_stb | affine | constant
    # acceptance rule for stabilization steps (the reference's simple_ls
    # accept_type, line_search.jl:46-57; take_step2! hard-wires
    # :accept_filter for stabilization, take_step.jl:62 — kept as default):
    #   accept_filter  — stable Armijo with filter fallback (filter_ls.jl)
    #   accept_stable  — Armijo on predicted merit reduction only
    #                    (stable_ls.jl; do_ls sign fixed, see PARITY.md)
    #   accept_kkt     — filter-only acceptance (kkt_ls.jl)
    #   accept_comp    — predicted-complementarity accuracy test
    #                    (basic_checks, line_search.jl:26-34; the reference's
    #                    Class_comp_ls is undefined — see PARITY.md)
    # Aggressive steps always use :accept_aggressive (take_step.jl:58).
    ls_mode_stable: str = "accept_filter"
    # f32-endgame precision guard (no reference counterpart — the reference
    # is f64 where merit reductions stay resolvable).  Near convergence the
    # true merit reduction ~ alpha*mu^2 drops below the floating-point
    # resolution eps*|merit| of the merit itself (at f32, eps ~ 1.2e-7, so
    # any tol < ~3e-4 run stalls: every trial "fails", delta escalates to
    # delta.max).  When the predicted reduction is below that noise floor,
    # acceptance falls back to the still-resolvable criteria: scaled KKT
    # error not increasing + interior invariant.  "auto" enables it for
    # f32/bf16 solves only (f64 behavior byte-identical to the reference),
    # "on"/"off" force it.
    precision_guard: str = "auto"
    precision_guard_factor: float = 16.0
    # when False, additionally require the primal step size to lie inside
    # the dual-feasible interval [lb, ub] (line_search.jl:100-104)
    move_primal_seperate_to_dual: bool = True
    dual_ls: int = 1
    comp_feas: float = 1.0 / 100.0
    comp_feas_agg: float = 1.0 / 50.0
    min_step_size_stable: float = 0.5 ** 5.0
    min_step_size_agg_ratio: float = 1e-4


@dataclass(frozen=True)
class TermParams:
    """Termination criteria (reference: src/parameters.jl:110-136)."""

    max_it: int = 3000
    max_time: float = 3600.0
    tol_opt: float = 1e-6
    tol_unbounded: float = 1e-12
    grad_max: float = math.inf
    tol_inf_1: float = 1e-3
    tol_inf_2: float = 1e-6
    dual_scale_threshold: float = 100.0
    dual_scale_mode: str = "max_dual"  # max_dual | ipopt | sqrt | exact | primal_dual
    # TPU addition: batched f32 solves re-measure the termination criteria
    # of still-RUNNING instances with f64 oracles BETWEEN jitted chunks
    # (parallel/batch.py).  The in-loop f32 measurement only produces
    # false negatives (noise sits on top of the true residuals), so the
    # recheck can only release instances, never mis-certify; needs
    # jax_enable_x64.
    batch_f64_recheck: bool = True
    # TPU addition: per-instance stall exit for batched f32 campaigns.  A
    # masked vmapped batch runs until its SLOWEST instance terminates, so
    # one f32-floor-limited straggler burns whole-batch iterations (the
    # median netlib-pool instance lands in ~14 outer its; a stalling one
    # forces all 120).  When > 0: an instance whose progress measure
    # mu + max_violation has not improved by stall_rtol in stall_patience
    # consecutive outer iterations exits with status STALLED, which the
    # bucket driver treats like MAX_IT (CPU-f64 escalation).  0 = off.
    stall_patience: int = 0
    stall_rtol: float = 0.02
    # TPU addition: resolution-limited recession-ray certificate.  The
    # reference certifies unboundedness via ||x||_inf > 1/tol_unbounded
    # (terminate.jl:3-23); reaching 1e12 requires the delta/inertia search
    # to admit delta ~ 1e-12 on the near-singular ray Schur complement.
    # On TPU, f64 is emulated and the Cholesky pivot screen floors delta
    # ~1e5x higher (measured on zoo lp_unbd: delta floor 3e-7 on-chip vs
    # 1e-12 on CPU), capping ray growth at ~||rhs||/delta per iteration —
    # the iterate provably rides the recession ray (full steps, primal
    # feasible, mu frozen) but cannot reach 1e12 in max_it.  When
    # unbounded_ray_patience > 0: an instance with NO progress in
    # mu + max_violation for that many outer iterations whose
    # ||x||_inf > unbounded_ray_norm while max_violation < tol_inf_1 is
    # certified dual_infeasible.  The instantaneous reference criterion
    # stays primary; this classifies only persistent feasible divergence.
    unbounded_ray_patience: int = 40
    unbounded_ray_norm: float = 1e8


@dataclass(frozen=True)
class DeltaParams:
    """Hessian-perturbation (inertia) parameters (reference: src/parameters.jl:138-159)."""

    max: float = 1e50
    start: float = 1e-6
    dec: float = 1.0 / math.pi
    inc: float = 8.0
    zero: float = 0.0
    min: float = 1e-12
    # static bound on factorization attempts inside the jitted inertia search
    # (reference MAX_IT=500, delta_strategy.jl:40; 8^70 from 1e-12 covers 1e50)
    max_it: int = 80
    # lag_cap (TPU addition): multiplicative cap on the `lag_delta_inc`
    # failure response delta <- ||grad L||_inf/||dx||_inf (one_phase.jl:
    # 234-240).  The reference's jump is unbounded: with an already-large
    # delta the direction norm is ~||rhs||/delta, so one line-search
    # failure can send delta from 1e7 to 1e36 in a single step, after
    # which directions are ~0, no-op steps get accepted, and delta only
    # anneals back at `dec`=1/pi per outer iteration — a measured
    # ~250-iteration freeze of the mu clock on the grouped-ECON endgame.
    # lag_cap bounds the jump to lag_cap * max(delta, delta.start);
    # inf reproduces the reference exactly (the default).
    lag_cap: float = float("inf")


@dataclass(frozen=True)
class InitParams:
    """Initialization parameters (reference: src/parameters.jl:162-202, :standard mode)."""

    mu_scale: float = 1.0
    mehotra_scaling: bool = True
    init_style: str = "gertz"          # gertz | mehrotra
    start_satisfying_bounds: bool = True
    # (the reference's init.dual_threshold is only read by its non-default
    # correct_guess variants, correct-guess.jl:69; the :gertz path ported
    # here uses correct_guess3 — knob intentionally not carried, PARITY.md)
    linear_scale: float = 1.0
    nl_ineq_scale: float = 1.0
    nl_eq_scale: float = 1.0
    dual_max: float = 1e3
    dual_min: float = 1e-2


@dataclass(frozen=True)
class TestingParams:
    """Failure-response switches (reference: src/parameters.jl:204-213)."""

    response_to_failure: str = "lag_delta_inc"  # lag_delta_inc | default


@dataclass(frozen=True)
class Params:
    """Top-level parameter tree (reference: src/parameters.jl:215-282)."""

    term: TermParams = field(default_factory=TermParams)
    init: InitParams = field(default_factory=InitParams)
    delta: DeltaParams = field(default_factory=DeltaParams)
    ls: LineSearchParams = field(default_factory=LineSearchParams)
    kkt: KKTParams = field(default_factory=KKTParams)
    test: TestingParams = field(default_factory=TestingParams)

    output_level: int = 2
    debug_mode: int = 0
    throw_error_nans: bool = False

    aggressive_dual_threshold: float = 1.0   # kappa_1
    primal_bounds_dual_feas: bool = False
    max_it_corrections: int = 2
    superlinear_theory_mode: bool = False
    agg_protection_factor: float = 0.9
    kkt_include_comp: bool = True
    a_norm_penalty: float = 1e-4
    # (the reference defines eps_mach=1e-16 but never reads it,
    # parameters.jl:240,278 — knob intentionally not carried, PARITY.md)

    # TPU-build additions (no reference counterpart):
    # MXU matmul precision for f32 solves.  JAX's TPU default lowers f32
    # matmuls to single-pass bf16 MXU ops (~8e-3 relative error), which
    # floors the KKT residual far above tol_opt: the solver literally never
    # certifies on a real TPU under the default.  "highest" (6-pass bf16,
    # f32-exact) restores certification; "high" (3-pass) is the measured
    # middle ground; "default" recovers the raw-bf16 behavior for
    # experiments.  No-op on CPU and for f64 solves.  The reference is
    # all-f64 and has no counterpart knob (src/parameters.jl).
    matmul_precision: str = "highest"
    # number of outer iterations executed per jitted chunk (wall-clock /
    # progress-printing granularity; does not affect the algorithm).
    chunk_size: int = 50
    # bound on step attempts with delta escalation (reference hardcodes 100,
    # one_phase.jl:221)
    max_step_attempts: int = 100
    # history ring capacity; >= max_it * max_it_corrections + 1 records kept.
    history_capacity: int = 0  # 0 -> auto
    # --- batched-solver (vmap) variants of the two knobs above ------------
    # Under vmap every bounded inner loop runs max-over-batch iterations, so
    # one stalling instance replays the full delta-escalation loop for the
    # whole batch.  BatchSolver therefore caps in-iteration step attempts at
    # `batch_max_step_attempts` (delta persists in the state, so escalation
    # spreads across outer iterations instead) — measured 2.2x batch
    # throughput with identical statuses and iteration counts on the f64
    # parity zoo.  Set to 0 to disable the cap (use `max_step_attempts`).
    batch_max_step_attempts: int = 4
    # History rings are per-instance under vmap ((B, cap, 32) arrays), so
    # batched solves default to a small ring; final-state summary metrics
    # (dual_feas, comp) are computed from the state instead.  Set to 0 to
    # keep full history in batches (memory: B * max_it * 2 * 32 * dtype).
    batch_history_capacity: int = 2

    def with_overrides(self, options: Dict[str, Any]) -> "Params":
        """Apply ``{"a!b": v}`` / ``{"a.b": v}`` path overrides (ref: create_pars_JuMP)."""
        out = self
        for key, val in options.items():
            parts = key.replace("!", ".").split(".")
            out = _set_path(out, parts, val)
        return out

    def flat(self) -> Dict[str, Any]:
        """Flatten to {'a.b': value} for dumping (reference: write_pars)."""
        res: Dict[str, Any] = {}

        def rec(obj, prefix):
            for f in fields(obj):
                v = getattr(obj, f.name)
                if dataclasses.is_dataclass(v):
                    rec(v, prefix + f.name + ".")
                else:
                    res[prefix + f.name] = v

        rec(self, "")
        return res

    def write_pars(self, stream) -> None:
        """Dump the parameter tree to a stream (reference: parameters.jl:215-300)."""
        stream.write("PAR\tVALUE\n")
        for k, v in self.flat().items():
            stream.write(f"{k:<44}\t{v}\n")


def _set_path(obj, parts, val):
    name = parts[0]
    if not hasattr(obj, name):
        raise KeyError(f"unknown parameter path component: {name!r}")
    if len(parts) == 1:
        cur = getattr(obj, name)
        if cur is not None and not isinstance(val, type(cur)):
            # coerce int->float etc. but reject nonsense
            if isinstance(cur, float) and isinstance(val, (int, float)):
                val = float(val)
            elif isinstance(cur, int) and isinstance(val, int):
                pass
            elif isinstance(cur, bool) and isinstance(val, bool):
                pass
            elif isinstance(cur, str) and isinstance(val, str):
                pass
            else:
                raise TypeError(f"parameter {name}: expected {type(cur).__name__}, got {type(val).__name__}")
        return replace(obj, **{name: val})
    sub = getattr(obj, name)
    return replace(obj, **{name: _set_path(sub, parts[1:], val)})
