"""End-to-end parity on the rest of the analytic zoo, its NLPs, the
starting-point problem, the bounds-only problem and the recorded history:
the port's `one_phase_solve` on the `pallas` and `xla` lanes against the
JAX package, float64 (tests/test_zoo.py)."""

import numpy as np
import pytest

from test_torch_twins import (ZOO_OPTS, assert_close, check_zoo_case,
                              jax_solve, port_solve, zoo_pair)
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAMES = ["rosenbrook3", "rosenbrook4", "circle2", "circle_nc2",
         "circle_nc_inf1", "circle_nc_unbd", "starting_point_0.5",
         "starting_point_-0.5", "bounds_only"]


@pytest.fixture(scope="module")
def jax_results():
    return {}


@pytest.mark.parametrize("lane", ["pallas", "xla"])
@pytest.mark.parametrize("name", NAMES)
def test_zoo_matches_jax(name, lane, jax_results):
    check_zoo_case(name, lane, jax_results)


def test_zoo_holds_every_jax_problem():
    """Every problem of the JAX package's zoo has its twin in the port."""
    import onephase_tpu.models.zoo as jzoo
    import onephase_tpu_torch.models.zoo as tzoo
    names = [k for k, v in vars(jzoo).items()
             if callable(v) and getattr(v, "__module__", "") == jzoo.__name__]
    assert len(names) >= 24
    for k in names:
        assert callable(getattr(tzoo, k, None)), k


@pytest.mark.parametrize("lane", ["pallas", "xla"])
def test_history_recorded_matches_jax(lane):
    """test_zoo.py's history checks on the port's toy_lp1 solve, and every
    history column equal to the JAX package's to 1e-8 (relative to
    max(1, max |column|))."""
    jspec, tspec = zoo_pair("toy_lp1")
    rj = jax_solve(jspec, ZOO_OPTS)
    r = port_solve(tspec, ZOO_OPTS, lane)
    assert len(r.history) >= 2
    assert r.history[0]["step_type"] == "it0"
    mus = [h["mu"] for h in r.history]
    assert mus[-1] < mus[0]
    assert r.history[-1]["primal_residual"] < 1e-5
    assert r.max_violation < 1e-6
    assert len(r.history) == len(rj.history)
    assert r.history[0].keys() == rj.history[0].keys()
    for key in rj.history[0]:
        got = [h[key] for h in r.history]
        want = [h[key] for h in rj.history]
        if isinstance(want[0], str):
            assert got == want, key
        else:
            assert_close(np.asarray(got, dtype=np.float64),
                         np.asarray(want, dtype=np.float64), 1e-8, key)
