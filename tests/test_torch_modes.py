"""The rest of the schur path's parity modes and its trace invariants,
through both packages, float64: tests/test_parity_modes.py's kernel-level
and batch-driver cases, and tests/test_trace_invariants.py's `schur_xla`
and `schur_invchol` configurations (the slack coupling, beta monotone,
the interior invariant and the rate coupling on the port's iterates, and
the port's trajectory against the JAX package's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onephase_tpu.config import Params as JParams
from onephase_tpu.ipm.core import OnePhaseKernel as JKernel
from onephase_tpu.nlp import canonicalize as jcanon
from onephase_tpu_torch.config import Params as TParams
from onephase_tpu_torch.interop import state_from_numpy
from onephase_tpu_torch.ipm.core import OnePhaseKernel as TKernel
from onephase_tpu_torch.ipm.state import MAX_TIME, RUNNING
from onephase_tpu_torch.nlp import canonicalize as tcanon
from test_torch_twins import (ZOO_OPTS, assert_close, jax_solve, port_solve,
                              zoo_pair)
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def test_primal_dual_scale_value():
    """thr / max(sqrt(||y||inf ||s||inf), thr) (IPM_tools.jl:17-18) in
    both packages on the same vectors."""
    pars = {"term.dual_scale_mode": "primal_dual", "output_level": 0}
    jspec, tspec = zoo_pair("toy_lp5")
    jk = JKernel(jcanon(jspec), JParams().with_overrides(pars))
    tk = TKernel(tcanon(tspec, device="cpu"), TParams().with_overrides(pars))
    rng = np.random.default_rng(4)
    for _ in range(3):
        y = rng.uniform(0.1, 500.0, size=tk.m)
        s = rng.uniform(0.1, 500.0, size=tk.m)
        want = 100.0 / max(np.sqrt(y.max() * s.max()), 100.0)
        got = float(tk.dual_scale(torch.tensor(y[None]),
                                  torch.tensor(s[None]))[0])
        ref = float(jk.dual_scale(jnp.asarray(y), jnp.asarray(s)))
        assert abs(got - want) <= 1e-15 * want
        assert abs(got - ref) <= 1e-15 * want
    full = torch.full((1, tk.m), 300.0, dtype=torch.float64)
    assert float(tk.dual_scale(full, full)[0]) == pytest.approx(100.0 / 300.0,
                                                                rel=1e-15)


def test_state_has_nan_detects():
    from onephase_tpu_torch.solver import _state_has_nan
    _, tspec = zoo_pair("toy_lp1")
    k = TKernel(tcanon(tspec, device="cpu"),
                TParams().with_overrides({"output_level": 0}))
    st = k.initial_state()
    assert not _state_has_nan(st)
    x = st.p.x.clone()
    x[0, 0] = float("nan")
    assert _state_has_nan(st._replace(p=st.p._replace(x=x)))


@pytest.mark.parametrize("lane", ["pallas", "xla"])
def test_it_refine_adaptive_direction(lane):
    """The adaptive-refinement direction equals the fixed-count one to
    1e-9 (relative to 1 + max |dx|), as in the JAX package, and each
    equals the JAX package's direction from the same carried state to
    1e-10, its a-posteriori KKT ratio below 1e-8."""
    dirs = {}
    jspec, tspec = zoo_pair("toy_lp3")
    for adaptive in (False, True):
        opts = dict(ZOO_OPTS, **{"kkt.it_refine_adaptive": adaptive,
                                 "kkt.linear_solver_type": lane})
        jk = JKernel(jcanon(jspec), JParams().with_overrides(
            dict(opts, **{"kkt.linear_solver_type": "xla"})))
        tk = TKernel(tcanon(tspec, device="cpu"),
                     TParams().with_overrides(opts))
        jst = jk.initial_state()
        st = state_from_numpy(_np_tree(jst), device="cpu")
        jf = jk.form_factor(jst.p, jst.cache, jst.fact)
        (jL, jD), jok = jk.factor(jf.Q, 1e-8)
        jf = jf._replace(L=jL, D=jD, delta=jnp.asarray(1e-8))
        jd, _ = jk.compute_direction(jf, jst.p, jst.cache, 0.0, 0.0, 0.0)
        tf = tk.form_factor(st.p, st.cache, st.fact)
        delta = torch.full((1,), 1e-8, dtype=torch.float64)
        (tL, tD), tok = tk.factor(tf.Q, delta, fact=tf)
        assert bool(tok[0]) and bool(jok)
        tf = tf._replace(L=tk.finalize_solver(tL), D=tD, delta=delta)
        zero = torch.zeros(1, dtype=torch.float64)
        td, ratio = tk.compute_direction(tf, st.p, st.cache, zero, zero,
                                         zero)
        assert float(ratio[0]) < 1e-8
        for leaf in ("x", "y", "s"):
            assert_close(getattr(td, leaf)[0], getattr(jd, leaf), 1e-10, leaf)
        dirs[adaptive] = td
    for leaf in ("x", "y", "s"):
        a = getattr(dirs[False], leaf)
        b = getattr(dirs[True], leaf)
        assert float((a - b).abs().max() / (1.0 + a.abs().max())) < 1e-9


def test_batch_step_attempts_knob():
    """The batch driver's documented variants of max_step_attempts and
    history_capacity, as in the JAX package."""
    from onephase_tpu.parallel.batch import BatchSolver as JBatch
    from onephase_tpu_torch.parallel.batch import BatchSolver as TBatch
    jspec, tspec = zoo_pair("rosenbrook2")
    jnlp, tnlp = jcanon(jspec), tcanon(tspec, device="cpu")
    for over, attr, want in (({}, "max_step_attempts", 4),
                             ({"batch_max_step_attempts": 0},
                              "max_step_attempts", 100)):
        opts = dict({"output_level": 0}, **over)
        tb = TBatch(tnlp, TParams().with_overrides(opts))
        jb = JBatch(jnlp, JParams().with_overrides(opts))
        assert getattr(tb.pars, attr) == getattr(jb.pars, attr) == want
    opts = {"output_level": 0, "batch_history_capacity": 0, "term.max_it": 50}
    assert TBatch(tnlp, TParams().with_overrides(opts)).kernel.hist_cap \
        == JBatch(jnlp, JParams().with_overrides(opts)).kernel.hist_cap \
        == 50 * 2 + 2


def test_batch_wall_clock_bound():
    """term.max_time = 0: every still-running instance ends MAX_TIME in
    both packages."""
    from onephase_tpu.parallel.batch import BatchSolver as JBatch
    from onephase_tpu_torch.parallel.batch import BatchSolver as TBatch
    jspec, tspec = zoo_pair("rosenbrook2")
    opts = {"output_level": 0, "term.max_time": 0.0, "chunk_size": 1,
            "term.max_it": 81}
    tnlp = tcanon(tspec, device="cpu")
    x0s = np.stack([tnlp.x0, tnlp.x0 + 0.1])
    st = TBatch(tnlp, TParams().with_overrides(opts)).solve(x0s)
    jst = JBatch(jcanon(jspec), JParams().with_overrides(opts)).solve(x0s)
    assert st.status.tolist() == [MAX_TIME] * 2
    assert np.asarray(jst.status).tolist() == [MAX_TIME] * 2


# ---------------------------------------------------------------------------
# tests/test_trace_invariants.py's schur configurations
CONFIGS = {"schur_xla": {}, "schur_invchol": {"kkt.linear_solver_type":
                                              "invchol"}}
PROBLEMS = ["toy_lp1", "rosenbrook2", "circle1", "toy_lp_inf1"]


def _drive(kernel, max_outer=60):
    st = kernel.initial_state()
    states = [st]
    while int(st.status[0]) == RUNNING and len(states) <= max_outer:
        st = kernel.run_chunk(st)
        states.append(st)
    return states


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("name", PROBLEMS)
def test_trace_invariants_and_trajectory(name, config):
    """On the port's iterates (chunks of one outer iteration): I1 slack
    coupling a(x) - s = beta r0 to 1e-9 (relative to 1 + max |r0|), I2
    beta non-increasing, I4 the interior invariant.  The trajectory equals
    the JAX package's on the same lane: status and t after every outer
    iteration exactly, x and mu to 1e-8 (relative to max(1, max |.|))."""
    opts = dict({"output_level": 0, "term.max_it": 60, "chunk_size": 1},
                **CONFIGS[config])
    jspec, tspec = zoo_pair(name)
    tk = TKernel(tcanon(tspec, device="cpu"), TParams().with_overrides(opts))
    jk = JKernel(jcanon(jspec), JParams().with_overrides(opts))
    states = _drive(tk)
    jst = jk.initial_state()
    jstates = [jst]
    while int(jst.status) == RUNNING and len(jstates) <= 60:
        jst = jk.run_chunk(jst)
        jstates.append(jst)
    assert len(states) == len(jstates)
    r0 = states[0].r0[0]
    scale = 1.0 + float(r0.abs().max())
    betas = []
    for st, js in zip(states, jstates):
        beta = float(st.p.beta[0])
        drift = float((st.cache.a[0] - st.p.s[0] - beta * r0).abs().max())
        assert drift <= 1e-9 * scale, (config, name, drift)
        assert bool(tk.is_feasible(st.p, tk.pars.ls.comp_feas)[0])
        betas.append(beta)
        assert int(st.status[0]) == int(js.status)
        assert int(st.t[0]) == int(js.t)
        assert_close(st.p.x[0], np.asarray(js.p.x), 1e-8, "x")
        assert_close(st.p.mu[0], np.asarray(js.p.mu), 1e-8, "mu")
    assert all(b2 <= b1 * (1 + 1e-12) for b1, b2 in zip(betas, betas[1:]))


@pytest.mark.parametrize("name", PROBLEMS)
def test_rate_coupling_history(name):
    """I3 over the port's recorded history of a default-config solve: mu
    and the primal residual contract by their predicted factors, at the
    same rate on aggressive steps; the history equals the JAX package's
    (mu, primal residual and alpha_P to 1e-8 relative to max(1, max))."""
    opts = {"output_level": 0, "term.max_it": 60}
    jspec, tspec = zoo_pair(name)
    hist = port_solve(tspec, opts, "xla").history
    jhist = jax_solve(jspec, opts).history
    assert len(hist) == len(jhist) >= 2
    for key in ("mu", "primal_residual", "alpha_P"):
        assert_close(np.array([h[key] for h in hist]),
                     np.array([h[key] for h in jhist]), 1e-8, key)
    moved = 0
    for r1, r2 in zip(hist, hist[1:]):
        mu1, mu2 = r1["mu"], r2["mu"]
        rp1, rp2 = r1["primal_residual"], r2["primal_residual"]
        if mu2 == mu1:
            assert abs(rp2 - rp1) <= 1e-9 * (1.0 + rp1), (name, r2)
            continue
        moved += 1
        a_p = r2["alpha_P"]
        f_mu = 1.0 - a_p * (1.0 - r2["eta_mu"])
        f_p = 1.0 - a_p * (1.0 - r2["eta_P"])
        assert np.isclose(mu2, mu1 * f_mu, rtol=1e-6, atol=1e-14)
        assert np.isclose(rp2, rp1 * f_p, rtol=1e-6,
                          atol=1e-12 * (1.0 + rp1))
        if r2["step_type"] == "agg":
            assert r2["eta_mu"] == r2["eta_P"], (name, r2)
    assert moved >= 1
