"""Baseline-solver adapters for benchmark campaigns.

Port of onephase_tpu/baselines.py.  Reference: benchmark/CUTEst/
run_cutest.jl:10-98 runs NLPModelsIpopt with matched settings as the
comparison lane.  Ipopt is not available; the equivalent lane here is
scipy's trust-constr interior-point method driven by the port's oracles
(values and derivatives by `torch.func` on the NLP's device, handed to
scipy as numpy), producing the same `Result`/summary records so it can feed
`harness.run_problems(solve_func=scipy_baseline_solve)` and the performance
profiles.  `scipy_linprog_solve` (HiGHS) and `performance_profile` are
numpy and scipy only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .config import Params
from .ipm.state import (DUAL_INFEASIBLE, MAX_IT, OPTIMAL, PRIMAL_INFEASIBLE,
                        STATUS_NAMES)
from .nlp import CanonNLP, NLPSpec, canonicalize
from .solver import Result


def scipy_baseline_solve(problem, pars: Optional[Params] = None,
                         options=None, method: str = "trust-constr",
                         device=None) -> Result:
    """Ipopt-class NLP baseline lane, config-matched the way the reference
    matched Ipopt's settings (run_cutest.jl:10-98: tol, max_iter, no
    scaling): `method` is scipy's "trust-constr" (interior-point,
    Ipopt-like, slow) or "SLSQP" (active-set SQP, completes far more
    instances per hour — the practical lane for iteration profiles).  An
    NLPSpec is canonicalized in float64 on `device` (default: the CUDA
    card); a CanonNLP keeps its own."""
    import torch
    from scipy.optimize import NonlinearConstraint, minimize

    pars = pars or Params()
    if options:
        pars = pars.with_overrides(options)
    nlp = (problem if isinstance(problem, CanonNLP)
           else canonicalize(problem, device=device))

    def dev(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               dtype=nlp.dtype, device=nlp.device)[None]

    def host(t):
        return t[0].double().cpu().numpy()

    def fun(x):
        return float(nlp.f(dev(x))[0])

    def jac(x):
        return host(nlp.grad_f(dev(x)))

    constraints = []
    if nlp.m_orig > 0:
        lcon = np.concatenate([
            np.full(nlp.n_lcon, -np.inf), np.full(nlp.n_ucon, -np.inf)])
        # express via original c(x) with its two-sided bounds
        lc = np.full(nlp.m_orig, -np.inf)
        uc = np.full(nlp.m_orig, np.inf)
        lc[nlp.li] = nlp.l
        uc[nlp.ui] = nlp.u
        constraints.append(NonlinearConstraint(
            lambda x: host(nlp.c(dev(x))), lc, uc,
            jac=lambda x: host(nlp.jac_orig(dev(x)))))

    bounds = list(zip(
        [b if np.isfinite(b) else -np.inf for b in nlp.lvar],
        [b if np.isfinite(b) else np.inf for b in nlp.uvar]))

    import time
    t0 = time.time()
    if method == "SLSQP":
        res = minimize(fun, np.asarray(nlp.x0), jac=jac, bounds=bounds,
                       constraints=constraints, method="SLSQP",
                       options={"maxiter": pars.term.max_it,
                                "ftol": pars.term.tol_opt})
    else:
        res = minimize(fun, np.asarray(nlp.x0), jac=jac, bounds=bounds,
                       constraints=constraints, method="trust-constr",
                       options={"maxiter": pars.term.max_it,
                                "gtol": pars.term.tol_opt,
                                "xtol": 1e-12,
                                "verbose": 0})
    wall = time.time() - t0

    x = np.asarray(res.x)
    a = host(nlp.a_of(dev(x)))
    vio = float(max(0.0, -a.min())) if a.size else 0.0
    niter = int(getattr(res, "niter", getattr(res, "nit", -1)))
    if method == "SLSQP":
        # SLSQP statuses: 0 success; 4/8 infeasible-ish; 9 max-iter
        if res.status == 0 and vio < 1e-6:
            code = OPTIMAL
        elif res.status == 9 or niter >= pars.term.max_it:
            code = MAX_IT
        else:
            code = PRIMAL_INFEASIBLE if vio >= 1e-6 else MAX_IT
    elif res.status in (1, 2) and vio < 1e-6:
        code = OPTIMAL
    elif res.status == 4:
        code = PRIMAL_INFEASIBLE
    elif res.status == 0:
        code = MAX_IT
    else:
        code = MAX_IT if niter >= pars.term.max_it else PRIMAL_INFEASIBLE

    x_full = np.array(nlp._x_template)
    x_full[nlp.free_idx] = x
    return Result(
        status=STATUS_NAMES[code], status_code=code, x=x_full,
        obj=float(res.fun), iterations=niter, history=[],
        y=np.zeros(nlp.m), constr_duals=np.zeros(nlp.m_orig),
        reduced_costs=np.zeros(nlp.n_full), mu=0.0, max_violation=vio,
        solve_time=wall)


def scipy_linprog_solve(problem, pars: Optional[Params] = None,
                        options=None) -> Result:
    """LP baseline lane: scipy.optimize.linprog (HiGHS dual simplex/IPM).

    The closest in-image stand-in for the reference's Ipopt lane on the
    Netlib LP campaigns (run_netlib.jl): an industrial solver with robust
    infeasibility detection.  Accepts `models.lp.LPData` (matrix form)."""
    import time

    from scipy.optimize import linprog

    from .models.lp import LPData

    pars = pars or Params()
    if options:
        pars = pars.with_overrides(options)
    assert isinstance(problem, LPData), "linprog lane needs LPData"
    d = problem
    m, n = d.A.shape
    is_eq = np.isfinite(d.lcon) & np.isfinite(d.ucon) & (d.lcon == d.ucon)
    A_eq = d.A[is_eq] if is_eq.any() else None
    b_eq = d.lcon[is_eq] if is_eq.any() else None
    ub_rows = ~is_eq & np.isfinite(d.ucon)
    lb_rows = ~is_eq & np.isfinite(d.lcon)
    A_ub = np.vstack([d.A[ub_rows], -d.A[lb_rows]])
    b_ub = np.concatenate([d.ucon[ub_rows], -d.lcon[lb_rows]])
    if A_ub.shape[0] == 0:
        A_ub, b_ub = None, None
    bounds = list(zip(
        [b if np.isfinite(b) else None for b in d.lvar],
        [b if np.isfinite(b) else None for b in d.uvar]))

    # hand HiGHS sparse matrices (it is a sparse solver; the dense ndarray
    # round-trip would penalize the baseline lane at scale)
    from scipy.sparse import csr_matrix
    if A_ub is not None:
        A_ub = csr_matrix(A_ub)
    if A_eq is not None:
        A_eq = csr_matrix(A_eq)

    t0 = time.time()
    # the IPM's max_it (outer interior-point iterations) is NOT a sensible
    # simplex pivot budget; give the industrial lane its own headroom
    res = linprog(d.cvec, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
                  bounds=bounds, method="highs",
                  options={"maxiter": max(10000, pars.term.max_it)})
    wall = time.time() - t0
    # highs status: 0 optimal, 1 iteration limit, 2 infeasible, 3 unbounded
    code = {0: OPTIMAL, 1: MAX_IT, 2: PRIMAL_INFEASIBLE,
            3: DUAL_INFEASIBLE}.get(res.status, MAX_IT)
    x = np.asarray(res.x) if res.x is not None else np.full(n, np.nan)
    ax = d.A @ x if res.x is not None else np.full(m, np.nan)
    vio = 0.0
    if res.x is not None:
        vio = float(max(0.0,
                        np.max(np.maximum(d.lcon - ax, ax - d.ucon),
                               initial=0.0)))
    nit = int(getattr(res, "nit", 0) or 0)
    return Result(
        status=STATUS_NAMES[code], status_code=code, x=x,
        obj=float(res.fun) if res.fun is not None else float("nan"),
        iterations=nit, history=[], y=np.zeros(m),
        constr_duals=np.zeros(m), reduced_costs=np.zeros(n), mu=0.0,
        max_violation=vio, solve_time=wall)


def performance_profile(summaries: dict, metric: str = "it_count",
                        ratio_max: float = 1e4):
    """Dolan-Moré performance profile data (reference: benchmark/plots.jl).

    summaries: {solver_name: {problem: ProblemSummary}}.
    Returns {solver_name: (taus, fraction_solved)} ready to plot/emit.
    """
    solvers = list(summaries)
    problems = sorted(set().union(*[set(s) for s in summaries.values()]))
    T = np.full((len(problems), len(solvers)), np.inf)
    for j, sv in enumerate(solvers):
        for i, p in enumerate(problems):
            rec = summaries[sv].get(p)
            if rec is None:
                continue
            ok = rec.status in ("optimal", "primal_infeasible")
            val = getattr(rec, metric)
            if ok and val is not None and val >= 0:
                T[i, j] = max(float(val), 1e-9)
    best = T.min(axis=1)
    ratios = T / best[:, None]
    taus = np.unique(np.clip(np.sort(ratios[np.isfinite(ratios)]),
                             1.0, ratio_max))
    out = {}
    for j, sv in enumerate(solvers):
        frac = [(ratios[:, j] <= t).mean() for t in taus]
        out[sv] = (taus, np.asarray(frac))
    return out
