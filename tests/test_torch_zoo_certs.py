"""End-to-end parity on the analytic zoo (infeasibility, unboundedness,
MAX_IT, HS071): the port's `one_phase_solve` on the `pallas` and `xla`
lanes against the JAX package, float64."""

import pytest

import onephase_tpu_torch
from onephase_tpu_torch.models import zoo
from test_torch_twins import check_zoo_case

NAMES = ["toy_lp_inf1", "lp_unbd", "quad_unbd", "unbd_feas", "hs071"]


@pytest.fixture(scope="module")
def jax_results():
    return {}


@pytest.mark.parametrize("lane", ["pallas", "xla"])
@pytest.mark.parametrize("name", NAMES)
def test_zoo_matches_jax(name, lane, jax_results):
    check_zoo_case(name, lane, jax_results)


def test_hs071_objective():
    r = onephase_tpu_torch.one_phase_solve(
        zoo.hs071(), options={"output_level": 0,
                              "kkt.linear_solver_type": "pallas"})
    assert r.status == "Optimal"
    assert abs(r.obj - 17.0140173) < 1e-6


def test_rosenbrook1_rejected():
    with pytest.raises(ValueError):
        onephase_tpu_torch.one_phase_solve(zoo.rosenbrook1(),
                                           options={"output_level": 0})
