"""Netlib-style LP test set (port of onephase_tpu/models/netlib.py).

The true Netlib instances are not redistributable inside this repo (and the
build environment has no network egress), so this module provides:

1. `load_netlib(dir)` — load real instances from a directory of MPS files
   via `lp.read_mps` (drop the Netlib archive there for full parity runs
   against benchmark-tables/table_netlib_infeasible_*.csv).
2. Synthetic stand-in families with the same *character* as the benchmark
   sets (reference: benchmark/Netlib/run_netlib.jl):
   - `feasible_suite()` — small degenerate feasible LPs (AFIRO-scale),
   - `infeasible_suite()` — LPs made infeasible by conflicting rows /
     range shifts, mirroring the lpi_* set's failure modes (empty polytope
     from contradictory inequalities, over-determined equalities, bound
     conflicts surfaced through Farkas certificates).

The data comes from the JAX package's numpy draws in the same order, so a
seed gives the same LPs array for array (tests/test_torch_netlib.py).
Every function that returns NLPSpecs takes `device` (default: the CUDA
card) for their data; the LPData forms need none.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List

import numpy as np

from ..nlp import NLPSpec
from .lp import LPData, lp_spec, perturb_infeasible, read_mps

INF = np.inf


def load_netlib(directory: str, device=None) -> Dict[str, NLPSpec]:
    out = {}
    for path in sorted(glob.glob(os.path.join(directory, "*"))):
        base = os.path.basename(path).lower()
        if not (base.endswith(".mps") or base.endswith(".mps.gz")
                or base.endswith(".sif")):
            continue
        name = base.split(".")[0]
        out[name] = read_mps(path, name=name, device=device)
    return out


def _rng(seed):
    return np.random.default_rng(seed)


def feasible_suite(sizes=((27, 32), (56, 97), (50, 48)),
                   seed: int = 0, device=None) -> Dict[str, NLPSpec]:
    """Random feasible LPs at (AFIRO, ADLITTLE, SC50A)-like sizes with a
    known interior feasible point, mixed equality/inequality rows."""
    names = ["afiro_like", "adlittle_like", "sc50a_like"]
    out = {}
    for k, (m, n) in enumerate(sizes):
        rng = _rng(seed + k)
        A = np.round(rng.normal(size=(m, n)) * (rng.random((m, n)) < 0.3), 3)
        A[np.all(A == 0, axis=1), 0] = 1.0   # no empty rows
        x_feas = rng.random(n)
        b = A @ x_feas
        lcon = np.where(np.arange(m) % 3 == 0, b, b - 1.0)   # every 3rd row eq
        ucon = np.where(np.arange(m) % 3 == 0, b, b + 1.0)
        cvec = rng.normal(size=n)
        out[names[k]] = lp_spec(cvec, A, lcon, ucon,
                                lvar=np.zeros(n), uvar=np.full(n, 10.0),
                                x0=np.full(n, 0.5), name=names[k],
                                device=device)
    return out


# ---------------------------------------------------------------------------
# The Netlib infeasible set (netlib.org/lp/infeas): 28 lpi_* problems solved
# by the reference (benchmark-tables/table_netlib_infeasible_one-phase.csv).
# The actual MPS files cannot ship in this repo (no redistribution, no
# network egress at build time), so `lpi_suite()` generates DIMENSION-MATCHED
# synthetic stand-ins: each problem has the published (rows, cols) of its
# namesake and an infeasibility mechanism matching the set's failure modes
# (empty polytope from range shifts against bounds, inconsistent equalities,
# sign conflicts, parallel-row interval conflicts).  Real instances dropped
# into --mps-dir take precedence for true parity runs.
#
# (rows, cols) from the netlib infeas index; mechanism cycles deterministically.
LPI_DIMS = {
    "lpi_bgdbg1": (349, 407), "lpi_bgetam": (401, 688),
    "lpi_bgindy": (2672, 10116), "lpi_bgprtr": (21, 34),
    "lpi_box1": (232, 261), "lpi_ceria3d": (3577, 824),
    "lpi_chemcom": (289, 720), "lpi_cplex1": (3006, 3221),
    "lpi_ex72a": (198, 215), "lpi_ex73a": (194, 211),
    "lpi_forest6": (67, 95), "lpi_galenet": (9, 8),
    "lpi_gosh": (3793, 10733), "lpi_gran": (2569, 2520),
    "lpi_greenbea": (2505, 5405), "lpi_itest2": (10, 4),
    "lpi_itest6": (12, 8), "lpi_klein1": (55, 54),
    "lpi_klein2": (478, 54), "lpi_klein3": (995, 88),
    "lpi_mondou2": (313, 604), "lpi_pang": (362, 460),
    "lpi_pilot4i": (411, 1000), "lpi_qual": (324, 464),
    "lpi_reactor": (319, 637), "lpi_refinery": (324, 464),
    "lpi_vol1": (324, 464), "lpi_woodinfe": (36, 89),
}

_MECHANISMS = ("range_shift", "eq_conflict", "sign_conflict",
               "interval_conflict")


def _lp_base(m: int, n: int, seed: int, density: float | None = None):
    """Random sparse-ish *feasible* LP base: known interior point
    x in (0, 10)^n, every 4th row an equality, box bounds [0, 10] (so any
    objective is bounded).  Shared by the infeasible stand-ins (which break
    it) and the feasible members of `mixed_suite` (which keep it).
    `density` defaults to ~8 nonzeros/row (Netlib-like); pass e.g. 0.5 for
    the dense regime of the throughput crossover campaign."""
    rng = _rng(seed)
    if density is None:
        density = min(1.0, max(0.02, 8.0 / n))  # ~8 nonzeros/row like Netlib
    A = rng.normal(size=(m, n)) * (rng.random((m, n)) < density)
    A[np.all(A == 0.0, axis=1), rng.integers(0, n)] = 1.0
    x_feas = 1.0 + 4.0 * rng.random(n)
    b = A @ x_feas
    is_eq = np.arange(m) % 4 == 0
    lcon = np.where(is_eq, b, b - 2.0)
    ucon = np.where(is_eq, b, b + 2.0)
    lvar = np.zeros(n)
    uvar = np.full(n, 10.0)
    return rng, A, b, is_eq, lcon, ucon, lvar, uvar


def _lpi_instance(name: str, m: int, n: int, mech: str, seed: int,
                  density: float | None = None) -> NLPSpec:
    """One dimension-matched infeasible LP.

    Base: `_lp_base` (feasible), then broken by `mech`.
    """
    rng, A, b, is_eq, lcon, ucon, lvar, uvar = _lp_base(m, n, seed, density)

    if mech == "range_shift":
        # reference infeas.jl mechanism: shift ranges until they conflict
        # with the bounds (rows demand A x well away from the box image)
        span = np.abs(A) @ uvar
        shift = span + 1.0
        lcon = lcon - shift
        ucon = ucon - shift
        # keep it nontrivial: only shift inequality rows; equalities anchor
        lcon = np.where(is_eq, b, lcon)
        ucon = np.where(is_eq, b, ucon)
        # a certificate exists through any single shifted row + bounds
    elif mech == "eq_conflict":
        # inconsistent equalities: duplicate row 1 into row 2 w/ other rhs
        A[1] = A[0]
        lcon[0] = ucon[0] = b[0]
        lcon[1] = ucon[1] = b[0] + 7.0
    elif mech == "sign_conflict":
        # nonnegative row over nonnegative vars required <= -1 (empty)
        A[0] = np.abs(A[0]) + (A[0] == 0.0) * 0.1
        lcon[0], ucon[0] = -INF, -1.0
    else:  # interval_conflict
        # parallel rows with disjoint intervals: row0 <= t, 2*row0 >= 2t+6
        A[1] = 2.0 * A[0]
        t = b[0]
        lcon[0], ucon[0] = -INF, t
        lcon[1], ucon[1] = 2.0 * t + 6.0, INF
    x0 = np.full(n, 5.0)
    return LPData(cvec=rng.normal(size=n), A=A, lcon=lcon, ucon=ucon,
                  lvar=lvar, uvar=uvar, x0=x0, name=name)


def lpi_suite(max_n: int | None = None, seed: int = 7,
              as_data: bool = False, device=None) -> Dict[str, NLPSpec]:
    """Dimension-matched stand-ins for the 28 Netlib lpi_* problems.

    `max_n` drops instances with more than max_n columns (the dense solve
    path scales as n^3 per factorization; the >5k-column members are TPU
    territory).  `as_data=True` returns raw LPData (for the bucketed batch
    driver and matrix-consuming baselines) instead of NLPSpec."""
    out = {}
    for i, (name, (m, n)) in enumerate(sorted(LPI_DIMS.items())):
        if max_n is not None and n > max_n:
            continue
        mech = _MECHANISMS[i % len(_MECHANISMS)]
        data = _lpi_instance(name, m, n, mech, seed + i)
        out[name] = data if as_data else data.to_spec(device=device)
    return out


def mixed_suite(n_pairs: int = 12, seed: int = 11, max_n: int = 600,
                as_data: bool = True, device=None):
    """Mixed feasible + infeasible pool at lpi_* dimensions — the
    *falsifiable* parity campaign (VERDICT r2 item 5): a solver that
    always declares `primal_infeasible` scores 50%, not 100%.  Feasible
    members are the unbroken `_lp_base` with a random objective; their
    optimal values are cross-checkable against an independent LP solver
    (the HiGHS lane, baselines.scipy_linprog_solve) on the identical data.

    Returns {name: LPData} (or NLPSpec with as_data=False); every name is
    suffixed `_feas`/`_infeas` with the ground-truth class.
    """
    dims = [d for d in sorted(LPI_DIMS.items()) if d[1][1] <= max_n]
    out = {}
    for i in range(n_pairs):
        base_name, (m, n) = dims[i % len(dims)]
        # feasible member: base LP + bounded random objective
        rng, A, b, is_eq, lcon, ucon, lvar, uvar = _lp_base(m, n, seed + 2 * i)
        d_feas = LPData(cvec=rng.normal(size=n), A=A, lcon=lcon, ucon=ucon,
                        lvar=lvar, uvar=uvar, x0=np.full(n, 5.0),
                        name=f"{base_name}_{i}_feas")
        # infeasible member: same dims, broken by the cycling mechanism
        mech = _MECHANISMS[i % len(_MECHANISMS)]
        d_inf = _lpi_instance(f"{base_name}_{i}_infeas", m, n, mech,
                              seed + 2 * i + 1)
        for d in (d_feas, d_inf):
            out[d.name] = d if as_data else d.to_spec(device=device)
    return out


def sized_mixed_suite(n: int, m: int, n_pairs: int, density: float | None = None,
                      seed: int = 23) -> Dict[str, LPData]:
    """Mixed feasible+infeasible pool at a FIXED shape (n cols, m rows) —
    the throughput-crossover campaign's unit (VERDICT r3 item 2): one
    shape class = one compiled batched solver, identical data to the
    baseline lane.  Same construction as `mixed_suite`, with problem size
    and density as free parameters."""
    out = {}
    for i in range(n_pairs):
        rng, A, b, is_eq, lcon, ucon, lvar, uvar = _lp_base(
            m, n, seed + 2 * i, density)
        d_feas = LPData(cvec=rng.normal(size=n), A=A, lcon=lcon, ucon=ucon,
                        lvar=lvar, uvar=uvar, x0=np.full(n, 5.0),
                        name=f"mix{n}_{i}_feas")
        mech = _MECHANISMS[i % len(_MECHANISMS)]
        d_inf = _lpi_instance(f"mix{n}_{i}_infeas", m, n, mech,
                              seed + 2 * i + 1, density)
        out[d_feas.name] = d_feas
        out[d_inf.name] = d_inf
    return out


def infeasible_suite(seed: int = 3, device=None) -> Dict[str, NLPSpec]:
    """Synthetic infeasible LPs in the spirit of the lpi_* Netlib set."""
    out = {}

    # conflicting parallel inequalities (lpi_itest6 spirit)
    rng = _rng(seed)
    n = 8
    A1 = rng.normal(size=(4, n))
    A = np.vstack([A1, A1[0]])
    lcon = np.concatenate([np.full(4, -INF), [2.0]])   # row0 <= 1, row0 >= 2
    ucon = np.concatenate([np.full(4, 1.0), [INF]])
    out["syn_parallel_conflict"] = lp_spec(
        rng.normal(size=n), A, lcon, ucon, lvar=np.zeros(n),
        uvar=np.full(n, 50.0), name="syn_parallel_conflict", device=device)

    # over-determined inconsistent equalities (lpi_woodinfe spirit)
    rng = _rng(seed + 1)
    n = 12
    A = rng.normal(size=(14, n))
    b = rng.normal(size=14)
    out["syn_overdetermined_eq"] = lp_spec(
        rng.normal(size=n), A, b, b, lvar=np.zeros(n),
        name="syn_overdetermined_eq", device=device)

    # nonnegativity vs negative row-sum requirement (lpi_bgprtr spirit)
    rng = _rng(seed + 2)
    n = 10
    A = np.abs(rng.normal(size=(3, n)))
    lcon = np.full(3, -INF)
    ucon = np.full(3, -1.0)     # sum of nonnegatives <= -1: empty
    out["syn_sign_conflict"] = lp_spec(
        np.ones(n), A, lcon, ucon, lvar=np.zeros(n), name="syn_sign_conflict",
        device=device)

    # feasible LP pushed infeasible by the range shift (infeas.jl mechanism)
    base = feasible_suite(seed=seed + 3, device=device)["afiro_like"]
    shifted = perturb_infeasible(base, scale=25.0)
    shifted.name = "syn_shifted_afiro"
    out["syn_shifted_afiro"] = shifted
    return out
