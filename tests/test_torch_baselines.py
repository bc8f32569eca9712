"""The port's baseline lanes (baselines.py) against the JAX package's: the
HiGHS LP lane on the same LPData, the scipy NLP lane driven by the port's
oracles (values and derivatives by torch.func, handed to scipy as numpy),
and the performance-profile data, on the CPU in float64."""

import numpy as np
import pytest

import onephase_tpu.baselines as jb
import onephase_tpu_torch.baselines as tb
from onephase_tpu.models import netlib as jnet
from onephase_tpu.models import zoo as jzoo
from onephase_tpu_torch.harness import ProblemSummary
from onephase_tpu_torch.models import netlib as tnet
from onephase_tpu_torch.models import zoo as tzoo
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_linprog_lane_matches_jax():
    """HiGHS on mixed_suite's LPs: the same statuses and objectives."""
    tpool = tnet.mixed_suite(n_pairs=3, max_n=100)
    jpool = jnet.mixed_suite(n_pairs=3, max_n=100)
    for name in jpool:
        rt = tb.scipy_linprog_solve(tpool[name])
        rj = jb.scipy_linprog_solve(jpool[name])
        truth = "Optimal" if name.endswith("_feas") else "primal_infeasible"
        assert rt.status == rj.status == truth, name
        if truth == "Optimal":
            assert rt.obj == rj.obj
            np.testing.assert_array_equal(rt.x, rj.x)
            assert rt.max_violation == pytest.approx(rj.max_violation,
                                                     abs=1e-12)


@pytest.mark.parametrize("name, method", [("hs071", "SLSQP"),
                                          ("circle1", "trust-constr")])
def test_scipy_nlp_lane_matches_jax(name, method):
    from test_torch_twins import jax_hs071
    jspec = jax_hs071() if name == "hs071" else getattr(jzoo, name)()
    tspec = getattr(tzoo, name)()
    opts = {"output_level": 0, "term.max_it": 200}
    rj = jb.scipy_baseline_solve(jspec, options=opts, method=method)
    rt = tb.scipy_baseline_solve(tspec, options=opts, method=method,
                                 device="cpu")
    assert rt.status == rj.status == "Optimal"
    assert rt.iterations == rj.iterations
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-7)
    assert rt.obj == pytest.approx(rj.obj, rel=1e-9)


def test_performance_profile_matches_jax():
    def rec(status, it):
        return ProblemSummary(status=status, it_count=it)

    summaries = {
        "one-phase": {"a": rec("optimal", 10), "b": rec("primal_infeasible",
                                                        30),
                      "c": rec("MAX_IT", 100)},
        "ipopt": {"a": rec("optimal", 20), "b": rec("optimal", 15),
                  "c": rec("optimal", 50)},
    }
    pt = tb.performance_profile(summaries)
    pj = jb.performance_profile(summaries)
    assert list(pt) == list(pj)
    for k in pj:
        for a, b in zip(pt[k], pj[k]):
            np.testing.assert_array_equal(a, b)
