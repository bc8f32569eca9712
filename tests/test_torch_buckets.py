"""The port's shape-bucketed LP driver (parallel/buckets.py) against the
JAX package's: tests/test_buckets.py's problems (different n and m,
missing bound sides, a fixed variable, an equality row, an infeasible
instance) in float64 (status, outer iterations, x to 1e-6, objective);
the numpy preprocessing array for array; the float64 escalation of a
float32 solve; and a small mixed feasible/infeasible pool in float32 with
escalation, held to its ground truth in both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onephase_tpu.parallel.buckets as jbk
import onephase_tpu_torch.parallel.buckets as tbk
from onephase_tpu.config import Params as JParams
from onephase_tpu_torch.config import Params as TParams
from onephase_tpu_torch.models.lp import LPData as TLPData
from test_buckets import _problems
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LP_FIELDS = ("cvec", "A", "lcon", "ucon", "lvar", "uvar", "x0", "name", "c0")


def _port_lp(d):
    return TLPData(**{f: getattr(d, f) for f in LP_FIELDS})


def _pair():
    ps = _problems()
    return ps, {k: _port_lp(v) for k, v in ps.items()}


def _same_lp(a, b):
    for f in LP_FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(va, vb, f)
        else:
            assert va == vb, f


@pytest.mark.parametrize("name", ["simplex2", "eq_fix3", "wide12", "infeas1"])
def test_preprocessing_equals_jax(name):
    jd, td = _problems()[name], _pair()[1][name]
    (jr, jx, jf), (tr, tx, tf) = jbk.eliminate_fixed(jd), tbk.eliminate_fixed(td)
    _same_lp(tr, jr)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(tf, jf)
    _same_lp(tbk.equilibrate_rows(tr), jbk.equilibrate_rows(jr))
    _same_lp(tbk.pad_lp(tr, 16, 8), jbk.pad_lp(jr, 16, 8))


def test_bucket_shapes_equal_jax():
    jps, tps = _pair()
    jd = [jbk.eliminate_fixed(d)[0] for d in jps.values()]
    td = [tbk.eliminate_fixed(d)[0] for d in tps.values()]
    for r in (8, 64):
        assert tbk.bucket_shapes(td, r) == jbk.bucket_shapes(jd, r)
    assert len(tbk.bucket_shapes(td, 8)) >= 2


def _same_results(rt, rj, names, x_tol=1e-6):
    for k in names:
        t, j = rt[k], rj[k]
        assert (t.status, t.iterations, t.escalated) == \
            (j.status, j.iterations, j.escalated), k
        np.testing.assert_allclose(t.x, j.x, rtol=0, atol=x_tol, err_msg=k)
        assert t.obj == pytest.approx(j.obj, rel=1e-8, abs=1e-10), k
        assert t.max_violation == pytest.approx(j.max_violation, abs=1e-10)
        assert t.dual_feas == pytest.approx(j.dual_feas, rel=1e-6, abs=1e-12)


def test_solve_bucketed_f64_matches_jax():
    """tests/test_buckets.py's campaign in float64: every instance as the
    JAX package solves it, and (as there) the argmins of the single
    solver."""
    from onephase_tpu_torch import one_phase_solve
    from onephase_tpu_torch.nlp import canonicalize
    jps, tps = _pair()
    opts = {"output_level": 0, "term.max_it": 200}
    rj = jbk.solve_bucketed(jps, JParams().with_overrides(opts), round_to=8,
                            dtype=jnp.float64)
    rt = tbk.solve_bucketed(tps, TParams().with_overrides(opts), round_to=8,
                            dtype=torch.float64, device="cpu")
    assert set(rt) == set(jps)
    _same_results(rt, rj, jps)
    assert rt["infeas1"].status == "primal_infeasible"
    for name in ("simplex2", "eq_fix3", "wide12"):
        single = one_phase_solve(canonicalize(tps[name].to_spec("cpu"),
                                              device="cpu"),
                                 options={"output_level": 0})
        assert rt[name].status == single.status == "Optimal"
        assert rt[name].obj == pytest.approx(single.obj, rel=1e-5, abs=1e-6)
        np.testing.assert_allclose(rt[name].x, single.x, atol=1e-4)
    assert rt["simplex2"].obj == pytest.approx(-1.0, abs=1e-5)
    assert rt["eq_fix3"].obj == pytest.approx(3.0, abs=1e-4)


def test_escalation_matches_jax():
    """A float32 solve at tol 1e-9 (below float32's reach) ends MAX_IT on
    every feasible instance; the float64 pass (max_it min(60, 80)) on the
    same device certifies them, as the JAX package's does, with its
    iterations and objectives.  The float32 verdict of the infeasible
    instance is kept (its float32 iteration count is round-off-decided,
    so only its status is held)."""
    jps, tps = _pair()
    opts = {"output_level": 0, "term.max_it": 60, "term.tol_opt": 1e-9}
    rj = jbk.solve_bucketed(jps, JParams().with_overrides(opts), round_to=8,
                            dtype=jnp.float32, escalate_f64=True)
    tbk._SOLVER_CACHE.clear()
    rt = tbk.solve_bucketed(tps, TParams().with_overrides(opts), round_to=8,
                            dtype=torch.float32, escalate_f64=True,
                            device="cpu")
    esc = ("simplex2", "eq_fix3", "wide12")
    assert all(rt[k].escalated and rt[k].status == "Optimal" for k in esc)
    _same_results(rt, rj, esc, x_tol=1e-8)
    assert rt["infeas1"].status == rj["infeas1"].status == "primal_infeasible"
    assert not rt["infeas1"].escalated and not rj["infeas1"].escalated
    # both passes ran on the caller's device, and the escalation pass in
    # float64 with its capped budget
    solvers = tbk.bucket_solvers()
    assert {s.dtype for s in solvers} == {torch.float32, torch.float64}
    assert {s.device for s in solvers} == {torch.device("cpu")}
    assert {s.pars.term.max_it for s in solvers
            if s.dtype == torch.float64} == {60}


def test_stall_exit_releases_straggler():
    """term.stall_patience as tests/test_buckets.py holds it: statuses and
    objectives unchanged on converging instances (float64, equal to the
    patience-off run), and a float32 instance at tol 1e-14 exits STALLED
    (or MAX_DELTA) long before max_it."""
    _, tps = _pair()
    base = {"output_level": 0, "term.max_it": 200}
    off = tbk.solve_bucketed(tps, TParams().with_overrides(base), round_to=8,
                             dtype=torch.float64, device="cpu")
    on = tbk.solve_bucketed(tps, TParams().with_overrides(
        dict(base, **{"term.stall_patience": 20})), round_to=8,
        dtype=torch.float64, device="cpu")
    for name in tps:
        assert on[name].status == off[name].status, name
        if on[name].status == "Optimal":
            assert on[name].obj == pytest.approx(off[name].obj, rel=1e-6,
                                                 abs=1e-8)
    hard = {"hard": tps["simplex2"]}
    r = tbk.solve_bucketed(hard, TParams().with_overrides({
        "output_level": 0, "term.max_it": 500, "term.tol_opt": 1e-14,
        "term.stall_patience": 20}), round_to=8, dtype=torch.float32,
        device="cpu")["hard"]
    assert r.status in ("STALLED", "MAX_DELTA"), r.status
    assert r.iterations < 450, r.iterations


def test_mixed_pool_f32_escalation_ground_truth():
    """mixed_suite(n_pairs=2, max_n=100) (two feasible and two infeasible
    LPs at lpi_* shapes) in float32 on the pallas lane with
    scripts/run_mixed_lanes.py's options and float64 escalation: every
    instance resolves to its ground truth (the `_feas` / `_infeas` suffix)
    in both packages."""
    import onephase_tpu.ops as jops
    from onephase_tpu.models.netlib import mixed_suite as jmixed
    from onephase_tpu_torch.models.netlib import mixed_suite as tmixed
    opts = {"output_level": 0, "term.max_it": 200, "term.tol_opt": 1e-4,
            "term.tol_inf_2": 1e-3, "chunk_size": 25,
            "kkt.linear_solver_type": "pallas",
            "kkt.it_refine_adaptive": True, "kkt.it_refine_max": 8,
            "kkt.it_refine_tol": 5e-7, "kkt.it_refine_highprec": True,
            "term.stall_patience": 25}
    jops.INTERPRET = True
    try:
        rj = jbk.solve_bucketed(jmixed(n_pairs=2, max_n=100),
                                JParams().with_overrides(opts), round_to=128,
                                dtype=jnp.float32, escalate_f64=True)
    finally:
        jops.INTERPRET = False
    rt = tbk.solve_bucketed(tmixed(n_pairs=2, max_n=100),
                            TParams().with_overrides(opts), round_to=128,
                            dtype=torch.float32, escalate_f64=True,
                            device="cpu")
    assert set(rt) == set(rj) and len(rt) == 4
    for name in rt:
        truth = "Optimal" if name.endswith("_feas") else "primal_infeasible"
        assert rj[name].status == truth, (name, rj[name].status)
        assert rt[name].status == truth, (name, rt[name].status)
        if truth == "Optimal":
            assert rt[name].obj == pytest.approx(rj[name].obj, rel=1e-3)
