"""`OnePhaseKernel` of the port against the JAX package's, step by step,
float64: the initial state, and one factor-and-direction cycle started from
the same (carried-across) JAX state."""

import jax
import numpy as np
import pytest
import torch

import onephase_tpu.ops as jops
from onephase_tpu.config import Params as JParams
from onephase_tpu.ipm.core import OnePhaseKernel as JKernel
from onephase_tpu.nlp import canonicalize as jcanon
from onephase_tpu_torch.config import Params as TParams
from onephase_tpu_torch.interop import state_from_numpy, state_to_numpy
from onephase_tpu_torch.ipm.core import OnePhaseKernel as TKernel
from onephase_tpu_torch.nlp import canonicalize as tcanon
from test_torch_twins import (assert_close as _assert_close,
                              compare_states as _compare_states, qp_pair,
                              zoo_pair)
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OPTS = {"term!max_it": 81, "a_norm_penalty": 1e-4, "output_level": 0}


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _problem(name):
    return qp_pair(32, 16) if name == "qp" else zoo_pair(name)


@pytest.fixture(params=["xla", "pallas"])
def lane(request):
    if request.param == "pallas":
        jops.INTERPRET = True
    try:
        yield request.param
    finally:
        jops.INTERPRET = False


def _kernels(name, lane):
    jspec, tspec = _problem(name)
    opts = dict(OPTS, **{"kkt.linear_solver_type": lane})
    jk = JKernel(jcanon(jspec), JParams().with_overrides(opts))
    tk = TKernel(tcanon(tspec, device="cpu"), TParams().with_overrides(opts))
    return jk, tk


@pytest.mark.parametrize("name", ["qp", "circle1"])
def test_initial_state_matches(name, lane):
    jk, tk = _kernels(name, lane)
    jst = _np_tree(jk.initial_state())
    tst = state_to_numpy(tk.initial_state())
    _compare_states(tst, jst, 1e-12)


@pytest.mark.parametrize("name", ["qp", "circle1"])
def test_factor_and_direction_cycle_matches(name, lane):
    jk, tk = _kernels(name, lane)
    jst = jk.initial_state()
    st = state_from_numpy(_np_tree(jst), device="cpu")
    assert st.p.x.shape == (1, tk.n)

    jf = jk.form_factor(jst.p, jst.cache, jst.fact, jst.pdata)
    tf = tk.form_factor(st.p, st.cache, st.fact)
    _assert_close(tf.Q[0], jf.Q, 1e-10, "Q")
    _assert_close(tf.schur_diag[0], jf.schur_diag, 1e-10, "schur_diag")

    jok, jnfac, jdelta, jLD = jk.ipopt_strategy(jf, jst.delta)
    tok, tnfac, tdelta, tLD = tk.ipopt_strategy(tf, st.delta)
    assert bool(tok[0]) == bool(jok)
    assert int(tnfac[0]) == int(jnfac)
    assert float(tdelta[0]) == float(jdelta)

    jM = jk.finalize_solver(jLD[0])
    tM = tk.finalize_solver(tLD[0])
    _assert_close(tM[0], jM, 1e-10, "finalized operator")

    jf = jf._replace(L=jM, D=jLD[1], delta=jdelta, ok=jok)
    tf = tf._replace(L=tM, D=tLD[1], delta=tdelta, ok=tok)
    for eta in ((0.0, 0.0, 0.0), (1.0, 0.0, 1.0), (0.3, 0.1, 0.2)):
        jdir, jratio = jk.compute_direction(jf, jst.p, jst.cache, *eta,
                                            jst.pdata)
        tdir, tratio = tk.compute_direction(
            tf, st.p, st.cache,
            *(torch.full((1,), e, dtype=torch.float64) for e in eta))
        for k in ("x", "y", "s", "mu", "beta"):
            _assert_close(getattr(tdir, k)[0], getattr(jdir, k), 1e-10, k)
        _assert_close(tratio[0], jratio, 1e-10, "kkt_ratio")


def test_one_chunk_from_carried_state_matches():
    """Five outer iterations of the port from the carried JAX state equal
    five of the JAX kernel (status, t, delta, cum_fac exactly; x to 1e-10)."""
    jk, tk = _kernels("circle1", "xla")
    jk.pars = jk.pars.with_overrides({"chunk_size": 5})
    tk.pars = tk.pars.with_overrides({"chunk_size": 5})
    jk.run_chunk = jax.jit(jk._run_chunk)
    jst = jk.initial_state()
    st = state_from_numpy(_np_tree(jst), device="cpu")
    jst = _np_tree(jk.run_chunk(jst))
    st = state_to_numpy(tk.run_chunk(st))
    for k in ("status", "t", "cum_fac", "tot_num_fac"):
        assert int(getattr(st, k)[0]) == int(getattr(jst, k)), k
    _assert_close(st.delta[0], jst.delta, 1e-10, "delta")
    _assert_close(st.p.x[0], jst.p.x, 1e-10, "x")
    _assert_close(st.p.mu[0], jst.p.mu, 1e-10, "mu")


@pytest.mark.parametrize("name", ["hs071", "circle1", "toy_lp5"])
def test_kkt_err_matches_jax(name):
    """OnePhaseKernel.kkt_err (scaled dual feasibility + ||comp||_inf,
    eval.jl:274-277) equals the JAX method's to 1e-12 in float64: at the
    JAX package's initial state, and at a seeded interior point (x off the
    start, y and s in [0.1, 2], mu = 0.3) whose caches each package forms
    with its own `make_cache`."""
    import jax.numpy as jnp
    jk, tk = _kernels(name, "xla")
    jst = jk.initial_state()
    st = state_from_numpy(_np_tree(jst), device="cpu")
    got = [tk.kkt_err(st.p, st.cache)]
    want = [jk.kkt_err(jst.p, jst.cache)]
    rng = np.random.default_rng(len(name))
    n, m = tk.n, tk.m
    x = np.asarray(jst.p.x) + 0.1 * rng.normal(size=n)
    y, s = rng.uniform(0.1, 2.0, size=(2, m))
    jp = jst.p._replace(x=jnp.asarray(x), y=jnp.asarray(y),
                        s=jnp.asarray(s), mu=jnp.asarray(0.3))
    want.append(jk.kkt_err(jp, jk.make_cache(jp.x, jp.y)))
    tp = st.p._replace(x=torch.as_tensor(x)[None],
                       y=torch.as_tensor(y)[None],
                       s=torch.as_tensor(s)[None],
                       mu=torch.full((1,), 0.3, dtype=torch.float64))
    got.append(tk.kkt_err(tp, tk.make_cache(tp.x, tp.y)))
    for g, w in zip(got, want):
        assert g.shape == (1,)
        np.testing.assert_allclose(g.numpy()[0], float(w), rtol=1e-12,
                                   atol=0)
