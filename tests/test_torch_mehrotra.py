"""The Mehrotra init (`init.init_style="mehrotra"`) on the dense Schur
path, held to the JAX package, float64.

The initial state is held leaf by leaf.  Whole solves are held to status
and argmin, and to outer iterations and the mu trace where the trajectory
is deterministic: on linear rows the init sets lb_s and lb_s_predict from
the same fraction_to_boundary_linear, so a correction's first trial step
lands its slack exactly on the bound it is then checked against
(`s_new >= lb_s`), and the last bit decides the trial.  The JAX package's
own lanes disagree there (toy_lp1: 6 outer iterations on xla, 5 on
invchol; circle1 8/8/7 on xla/invchol/pallas; rosenbrook2 57/47/44);
test_first_trial_lands_on_its_bound shows the tie."""

import jax
import numpy as np
import pytest
import torch

import onephase_tpu.nlp as jnlp
import onephase_tpu_torch.nlp as tnlp
from onephase_tpu.config import Params as JParams
from onephase_tpu.ipm.core import OnePhaseKernel as JKernel
from onephase_tpu_torch.config import Params as TParams
from onephase_tpu_torch.interop import state_from_numpy, state_to_numpy
from onephase_tpu_torch.ipm.core import OnePhaseKernel as TKernel
from test_torch_twins import (ZOO_OPTS, check_solve_parity, compare_states,
                              jax_solve, port_solve, zoo_pair)
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MEHROTRA = dict(ZOO_OPTS, **{"init.init_style": "mehrotra"})
# the port's lane and the JAX lane that computes the same operator on
# the CPU (the pallas lane's plain twins are the invchol lane's XLA ops)
JAX_LANE = {"xla": "xla", "pallas": "invchol"}


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _kernels(name, lane, over=None):
    jspec, tspec = zoo_pair(name)
    opts = dict(MEHROTRA, **(over or {}))
    jk = JKernel(jnlp.canonicalize(jspec), JParams().with_overrides(
        dict(opts, **{"kkt.linear_solver_type": JAX_LANE[lane]})))
    tk = TKernel(tnlp.canonicalize(tspec, device="cpu"),
                 TParams().with_overrides(
                     dict(opts, **{"kkt.linear_solver_type": lane})))
    return jk, tk


@pytest.mark.parametrize("lane", ["pallas", "xla"])
@pytest.mark.parametrize("name", ["circle1", "toy_lp1", "rosenbrook2",
                                  "hs071"])
def test_initial_state_matches(name, lane):
    """The ridge least-squares duals, the slacks, mu, the factor at
    delta.start and the per-row fraction-to-boundary vectors, leaf by
    leaf to 1e-12 (relative to max(1, max |leaf|))."""
    jk, tk = _kernels(name, lane)
    compare_states(state_to_numpy(tk.initial_state()),
                   _np_tree(jk.initial_state()), 1e-12)
    np.testing.assert_array_equal(tk.frac_bd.numpy(), np.asarray(jk.frac_bd))
    np.testing.assert_array_equal(tk.frac_bd_predict.numpy(),
                                  np.asarray(jk.frac_bd_predict))


@pytest.mark.parametrize("over", [
    {"init.mehotra_scaling": False},
    {"init.nl_eq_scale": 2.0, "init.nl_ineq_scale": 3.0,
     "init.linear_scale": 0.5},
], ids=["no_scaling", "class_scales"])
def test_initial_state_scaling_branches(over):
    """correct_guess3's unscaled branch and the per-class constraint
    weights, on HS071 (a nonlinear equality and inequality, linear bound
    rows): leaf by leaf to 1e-12."""
    jk, tk = _kernels("hs071", "xla", over)
    compare_states(state_to_numpy(tk.initial_state()),
                   _np_tree(jk.initial_state()), 1e-12)


@pytest.mark.parametrize("lane", ["pallas", "xla"])
@pytest.mark.parametrize("name", ["hs071", "quad_opt"])
def test_solve_matches(name, lane):
    """Deterministic trajectories: status, outer iterations, argmin to
    1e-6 and the mu trace to 1e-8."""
    jspec, tspec = zoo_pair(name)
    check_solve_parity(port_solve(tspec, MEHROTRA, lane),
                       jax_solve(jspec, MEHROTRA, JAX_LANE[lane]))


@pytest.mark.parametrize("lane", ["pallas", "xla"])
@pytest.mark.parametrize("name", ["toy_lp1", "toy_lp2", "circle1",
                                  "circle_nc1", "rosenbrook2", "toy_lp3"])
def test_solve_certifies_like_jax(name, lane):
    """Trajectories that tie on a bound (module docstring): the JAX
    package's status, and its argmin to 1e-5 (relative to max(1, |x|);
    both runs stop at tol_opt = 1e-6 on different iterates)."""
    jspec, tspec = zoo_pair(name)
    check_solve_parity(port_solve(tspec, MEHROTRA, lane),
                       jax_solve(jspec, MEHROTRA, JAX_LANE[lane]),
                       x_tol=1e-5, iterations=False)


def test_first_trial_lands_on_its_bound():
    """toy_lp3: the first outer iteration's factor step equals the JAX
    package's from the same state (1e-10); in the correction that follows
    the first trial's slack on the linear row equals its bound lb_s to
    within 4 rounding units of a(x), so the acceptance of that trial is
    decided by rounding."""
    jk, tk = _kernels("toy_lp3", "xla")
    jst = jk.initial_state()
    st = state_from_numpy(_np_tree(jst), device="cpu")
    one = torch.ones(1, dtype=torch.bool)
    j1 = jk.inner_step(jst, True)
    t1 = tk.inner_step(st, True, one)
    compare_states(state_to_numpy(t1), _np_tree(j1), 1e-10)
    be = tk.switching_condition(t1)
    assert bool(be[0]) and bool(jk.switching_condition(j1))
    _, _, _, _, d, _, _ = tk.take_step(t1, be, torch.zeros(1,
                                                           dtype=torch.bool))
    p = t1.p
    alpha0 = tk.simple_max_step(p.s, d.s, tk.lb_s_predict(p.s, d.x))
    x_new = p.x + d.x * alpha0[:, None]
    a_new = tk.nlp.a_of(x_new, tk.nlp.c(x_new), t1.bvals)
    s_new = a_new - (p.beta + d.beta * alpha0)[:, None] * t1.r0
    lb_s = tk.lb_s(p.s, d.x)
    lin = torch.as_tensor(tk.nlp.lin_mask[:tk.nlp.m_cons])
    gap = (s_new - lb_s)[0, :tk.nlp.m_cons][lin].abs().min()
    ulp_a = np.finfo(np.float64).eps * max(1.0, float(a_new.abs().max()))
    assert float(gap) <= 4 * ulp_a
