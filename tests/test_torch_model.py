"""The port's modelling front-end (model.py) against the JAX package's:
tests/test_model.py's cases built in both packages and solved in float64
on the CPU, held to the same status, outer iterations, values, duals and
reduced costs (1e-8, relative where they are large)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onephase_tpu.model as jmodel
import onephase_tpu_torch.model as tmodel
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OPTS = {"output_level": 0, "term!max_it": 81}


def _linear(M, xp):
    m = M.Model(options=dict(OPTS))
    x = m.add_variable(lb=0.0, ub=1.0, name="x")
    y = m.add_variable(lb=0.0, ub=1.0, name="y")
    m.add_linear_constraint({x: 1.0, y: 1.0}, lb=1.0, ub=2.0)
    m.set_objective({x: 1.0})
    return m, (x, y)


def _maximize_quadratic(M, xp):
    m = M.Model(options=dict(OPTS))
    x = m.add_variable(lb=0.0)
    y = m.add_variable(lb=0.0)
    m.add_quadratic_constraint([(x, x, 1.0), (y, y, 1.0)], ub=1.0)
    m.maximize(lambda v: v[0] + v[1])
    return m, (x, y)


def _nonlinear_fixed(M, xp):
    m = M.Model(options=dict(OPTS))
    x = m.add_variable(start=1.0)
    y = m.add_variable(start=1.0)
    z = m.add_variable()
    m.fix_variable(z, 3.0)
    m.add_nonlinear_constraint(lambda v: v[0] ** 2 + v[1] ** 2, lb=1.0,
                               ub=1.0)
    m.minimize(lambda v: v[0] + 0.0 * v[2])
    return m, (x, y, z)


def _infeasible(M, xp):
    m = M.Model(options=dict(OPTS))
    x = m.add_variable(lb=0.0)
    y = m.add_variable(lb=0.0)
    m.add_linear_constraint({x: 1.0, y: 2.0}, ub=-1.0)
    m.set_objective({x: 1.0, y: 100.0})
    return m, (x, y)


def _duals_lp(M, xp):
    m = M.Model(options=dict(OPTS))
    x = m.add_variable()
    m.add_linear_constraint({x: 1.0}, lb=4.0)
    m.set_objective({x: 1.0})
    return m, (x,)


def _iteration_limit(M, xp):
    m = M.Model(options={"output_level": 0, "term!max_it": 1})
    x = m.add_variable(lb=0.0, start=5.0)
    m.add_nonlinear_constraint(lambda v: (v[0] - 2.0) ** 4, ub=10.0)
    m.minimize(lambda v: (v[0] - 2.0) ** 2)
    return m, (x,)


def _mixed_rows(M, xp):
    """All three row kinds in one model, in the reference's order (linear,
    quadratic, nonlinear) whatever the order they were added in."""
    m = M.Model(options=dict(OPTS))
    x = m.add_variable(lb=-2.0, ub=2.0, start=0.5)
    y = m.add_variable(lb=-2.0, ub=2.0, start=0.5)
    m.add_nonlinear_constraint(lambda v: xp.exp(v[0]) + v[1], ub=3.0)
    m.add_quadratic_constraint([(x, y, 1.0)], lin={x: 0.5}, lb=-1.0)
    m.add_linear_constraint({x: 1.0, y: -1.0}, lb=-1.0, ub=1.0)
    m.minimize(lambda v: (v[0] - 1.0) ** 2 + (v[1] + 0.5) ** 2)
    return m, (x, y)


CASES = {
    "linear": (_linear, "LOCALLY_SOLVED"),
    "maximize_quadratic": (_maximize_quadratic, "LOCALLY_SOLVED"),
    "nonlinear_fixed": (_nonlinear_fixed, "LOCALLY_SOLVED"),
    "infeasible": (_infeasible, "INFEASIBLE"),
    "duals_lp": (_duals_lp, "LOCALLY_SOLVED"),
    "iteration_limit": (_iteration_limit, None),
    "mixed_rows": (_mixed_rows, "LOCALLY_SOLVED"),
}


def test_status_map_equal():
    assert tmodel.STATUS_TO_MOI == jmodel.STATUS_TO_MOI


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_jax(case):
    build, expect = CASES[case]
    mj, vj = build(jmodel, jnp)
    mt, vt = build(tmodel, torch)
    assert mt.termination_status == "OPTIMIZE_NOT_CALLED"
    mj.optimize()
    mt.optimize(device="cpu")
    assert mt.termination_status == mj.termination_status
    assert mt.raw_status == mj.raw_status
    if expect is not None:
        assert mt.termination_status == expect
    else:
        assert mt.termination_status in ("ITERATION_LIMIT", "LOCALLY_SOLVED")
    assert mt.result.iterations == mj.result.iterations
    # to 1e-8 absolute, or relative where a certificate's duals are large
    close = dict(rel=1e-8, abs=1e-8)
    for a, b in zip(vt, vj):
        assert mt.value(a) == pytest.approx(mj.value(b), **close)
        assert mt.reduced_cost(a) == pytest.approx(mj.reduced_cost(b),
                                                   **close)
    for i in range(len(mj.result.constr_duals)):
        assert mt.dual(i) == pytest.approx(mj.dual(i), **close)
    assert mt.objective_value == pytest.approx(mj.objective_value, **close)
    spec = mt.build_spec("cpu")
    assert tuple(spec.lin) == tuple(mj.build_spec().lin)
    np.testing.assert_array_equal(spec.lcon, mj.build_spec().lcon)


def test_reference_values():
    """tests/test_model.py's expectations on the port's own results."""
    m, (x, y) = _linear(tmodel, torch)
    m.optimize(device="cpu")
    assert abs(m.value(x)) < 1e-3 and abs(m.value(y) - 1.0) < 1e-3
    m, (x, y) = _maximize_quadratic(tmodel, torch)
    m.optimize(device="cpu")
    s = np.sqrt(0.5)
    assert abs(m.value(x) - s) < 1e-3 and abs(m.objective_value - 2 * s) < 1e-3
    m, (x, y, z) = _nonlinear_fixed(tmodel, torch)
    m.optimize(device="cpu")
    assert abs(m.value(x) + 1.0) < 1e-3 and m.value(z) == 3.0
    m, (x,) = _duals_lp(tmodel, torch)
    m.optimize(device="cpu")
    assert abs(m.dual(0) - 1.0) < 1e-4 and abs(m.value(x) - 4.0) < 1e-3
