"""End-to-end parity on the analytic zoo (optimal certificates): the port's
`one_phase_solve` on the `pallas` and `xla` lanes against the JAX package,
float64."""

import pytest

from test_torch_twins import check_zoo_case

NAMES = ["rosenbrook2", "toy_lp0", "toy_lp1", "circle1", "circle_nc1",
         "quad_opt"]


@pytest.fixture(scope="module")
def jax_results():
    return {}


@pytest.mark.parametrize("lane", ["pallas", "xla"])
@pytest.mark.parametrize("name", NAMES)
def test_zoo_matches_jax(name, lane, jax_results):
    check_zoo_case(name, lane, jax_results)
