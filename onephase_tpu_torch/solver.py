"""User-facing driver: `one_phase_solve`.

Port of onephase_tpu/solver.py (reference: src/IPM/one_phase.jl:7-89).
The kernel runs in chunks of outer iterations, so the wall-clock limit
(`term.max_time`) and progressive console output live between chunks.  A
single solve is a batch of 1.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .config import Params
from .ipm import history as hist_mod
from .ipm.core import OnePhaseKernel, make_kernel
from .ipm.state import MAX_TIME, RUNNING, STATUS_NAMES, State
from .nlp import CanonNLP, canonicalize
from .utils.timer import Timer


class EvalNaNError(RuntimeError):
    """NaN/Inf escaped into the iterate (reference `Eval_NaN_error`);
    raised between chunks when `pars.throw_error_nans` is set."""


def _state_has_nan(st: State) -> bool:
    for v in (st.p.x, st.p.s, st.p.y, st.p.mu, st.cache.fval, st.cache.g):
        if not bool(torch.isfinite(v).all()):
            return True
    return False


@dataclass
class Result:
    """Solve result (reference returns (iter, status, hist, t, err, timer))."""

    status: str
    status_code: int
    x: np.ndarray            # full-variable primal solution
    obj: float
    iterations: int
    history: List[dict]
    y: np.ndarray            # canonical duals
    constr_duals: np.ndarray  # per original constraint: y_l - y_u
    reduced_costs: np.ndarray  # per variable (reference get_reducedcosts)
    mu: float
    max_violation: float
    solve_time: float
    kernel: Any = field(repr=False, default=None)
    state: Any = field(repr=False, default=None)
    timer: Optional[Timer] = field(repr=False, default=None)


def one_phase_solve(problem, pars: Optional[Params] = None,
                    options: Optional[Dict[str, Any]] = None,
                    kernel: Optional[OnePhaseKernel] = None) -> Result:
    """Solve ``min f(x) s.t. lcon<=c(x)<=ucon, lvar<=x<=uvar``.

    `problem` is an `NLPSpec` (canonicalized in float64 on the CPU) or a
    `CanonNLP` (its dtype and device are used).  `options` are string-path
    overrides (``"term!max_it"`` / ``"term.max_it"``).
    """
    pars = pars or Params()
    if options:
        pars = pars.with_overrides(options)

    timer = Timer()
    with timer.span("INIT"):
        if kernel is None:
            with timer.span("canonicalize"):
                canon = (problem if isinstance(problem, CanonNLP)
                         else canonicalize(problem))
            with timer.span("build_kernel"):
                kernel = make_kernel(canon, pars)
        with timer.span("initial_state"):
            st = kernel.initial_state()

    printed = 0
    if pars.output_level >= 1:
        print(hist_mod.HEADER)

    t_start = time.time()
    status = int(st.status[0])
    with timer.span("IPM"):
        while status == RUNNING:
            with timer.span("chunk"):
                st = kernel.run_chunk(st)
                status = int(st.status[0])  # waits for the device
            with timer.span("progress"):
                printed = _print_progress(st, printed, pars,
                                          final=status != RUNNING)
            if pars.throw_error_nans and _state_has_nan(st):
                raise EvalNaNError(
                    f"NaN in iterate at outer iteration {int(st.t[0])}")
            if pars.debug_mode >= 1 and status == RUNNING:
                if not bool(kernel.is_feasible(st.p, pars.ls.comp_feas)[0]):
                    raise AssertionError(
                        f"interior invariant violated at outer iteration "
                        f"{int(st.t[0])} (debug_mode check)")
            if status == RUNNING and time.time() - t_start > pars.term.max_time:
                st = st._replace(status=torch.full_like(st.status, MAX_TIME))
                status = MAX_TIME
                break

    if pars.output_level >= 1:
        print(f"Terminated with {STATUS_NAMES[status]}")

    with timer.span("FINALIZE"):
        res = finalize_result(kernel, st, time.time() - t_start, timer)
    if pars.output_level >= 3:
        timer.print_stats()
    return res


def finalize_result(kernel: OnePhaseKernel, st: State, wall: float,
                    timer: Optional[Timer] = None, index: int = 0) -> Result:
    """Host-side Result of instance `index` of a (batched) state: full x,
    constraint duals and reduced costs (solver.py:134-167)."""
    nlp = kernel.nlp
    count = int(st.hist.count[index])
    records = hist_mod.rows_to_records(
        st.hist.buf[index].double().cpu().numpy(), count)

    x_red = st.p.x[index].double().cpu().numpy()
    x_full = np.array(nlp._x_template)
    x_full[nlp.free_idx] = x_red
    y = st.p.y[index].double().cpu().numpy()

    # constraint duals: lambda_i = y_l(i) - y_u(i) on original constraints
    lam = np.zeros(nlp.m_orig)
    np.add.at(lam, nlp.li, y[:nlp.n_lcon])
    np.add.at(lam, nlp.ui, -y[nlp.n_lcon:nlp.n_lcon + nlp.n_ucon])
    # reduced costs (reference get_reducedcosts, Class_cutest.jl:515-538)
    rc = np.zeros(nlp.n)
    st_l = nlp.m_cons
    np.add.at(rc, nlp.lvi, y[st_l:st_l + nlp.n_lvar])
    np.add.at(rc, nlp.uvi, -y[st_l + nlp.n_lvar:])
    rc_full = np.zeros(nlp.n_full)
    rc_full[nlp.free_idx] = rc

    a = st.cache.a[index].double().cpu().numpy()
    status = int(st.status[index])
    return Result(
        status=STATUS_NAMES[status], status_code=status,
        x=x_full, obj=float(st.cache.fval[index]),
        iterations=int(st.t[index]) - 1, history=records,
        y=y, constr_duals=lam, reduced_costs=rc_full,
        mu=float(st.p.mu[index]),
        max_violation=float(max(0.0, -a.min())) if a.size else 0.0,
        solve_time=wall, kernel=kernel, state=st, timer=timer)


def _print_progress(st, printed, pars, final=False):
    if pars.output_level < 1:
        return printed
    count = int(st.hist.count[0])
    if count <= printed:
        return printed
    buf = st.hist.buf[0, printed:count].double().cpu().numpy()
    recs = hist_mod.rows_to_records(buf, count - printed)
    thr = pars.term.dual_scale_threshold
    last_t = None
    for i, r in enumerate(recs):
        scale = thr / max(r["y_norm"], thr)
        is_first_of_t = r["t"] != last_t
        last_t = r["t"]
        lvl = pars.output_level
        show = (lvl >= 4 or (lvl >= 3 and is_first_of_t)
                or (lvl == 2 and r["t"] % 10 == 1 and is_first_of_t)
                or (final and printed + i == count - 1))
        if show:
            print(hist_mod.format_row(r, scale))
    return count
