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
