"""End-to-end parity on the rest of the analytic zoo, its LPs: the port's
`one_phase_solve` on the `pallas` and `xla` lanes against the JAX package,
float64 (tests/test_zoo.py's LP cases)."""

import pytest

from test_torch_twins import check_zoo_case
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAMES = ["toy_lp2", "toy_lp3", "toy_lp5", "toy_lp6", "toy_lp7", "toy_lp8",
         "toy_lp_inf2"]


@pytest.fixture(scope="module")
def jax_results():
    return {}


@pytest.mark.parametrize("lane", ["pallas", "xla"])
@pytest.mark.parametrize("name", NAMES)
def test_zoo_matches_jax(name, lane, jax_results):
    check_zoo_case(name, lane, jax_results)
