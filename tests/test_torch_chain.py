"""The port's chain path (parallel/chain.py, block-tridiagonal Schur) against
the JAX package's ChainKernel, and against the port's own dense path, on
the CPU in float64.

chain_ocp(K=8, nx=6, mc=3) (n = 48, m = 117 canonical rows) on the `xla`
lane (sequential block recursion) and the `pallas` lane (the K5/K7 plain
versions here; the JAX package runs its Pallas solve in interpret mode and
factors with XLA, which is the same arithmetic).  Tolerances: the initial
state to 1e-10 and the first direction to 1e-9 of the largest entry; the
run to termination with equal status and outer-iteration count, x to 1e-8
and the per-iteration mu trace to 1e-8 relative.
"""

import jax
import numpy as np
import pytest
import torch

import onephase_tpu.ops as jops
from onephase_tpu import one_phase_solve as jsolve
from onephase_tpu.config import Params as JParams
from onephase_tpu.models.examples import chain_ocp as jchain
from onephase_tpu.parallel.chain import ChainKernel as JChain
from onephase_tpu_torch import one_phase_solve as tsolve
from onephase_tpu_torch.config import Params as TParams
from onephase_tpu_torch.interop import state_from_numpy, state_to_numpy
from onephase_tpu_torch.ipm.core import OnePhaseKernel
from onephase_tpu_torch.ipm.state import OPTIMAL
from onephase_tpu_torch.models.examples import chain_ocp as tchain
from onephase_tpu_torch.nlp import canonicalize
from onephase_tpu_torch.parallel.chain import ChainKernel as TChain
from test_torch_twins import compare_states as _compare
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")
SHAPE = dict(K=8, nx=6, mc=3)
OPTS = {"output_level": 0, "term.max_it": 100, "chunk_size": 100}


def _opts(lane, **extra):
    return dict(OPTS, **{"kkt.linear_solver_type": lane}, **extra)


def _tkernel(lane, shape=SHAPE, **extra):
    return TChain(tchain(**shape, device="cpu"),
                  TParams().with_overrides(_opts(lane, **extra)), device=CPU)


@pytest.fixture(scope="module")
def jax_runs():
    """Per lane: the JAX kernel, its initial state (numpy leaves) and,
    unless `solve` is False, its solve; each computed once, with the
    Pallas solve in interpret mode."""
    runs, pars = {}, {}

    def get(lane, solve=True):
        if lane not in runs:
            jops.INTERPRET = lane == "pallas"
            try:
                pars[lane] = JParams().with_overrides(_opts(lane))
                jk = JChain(jchain(**SHAPE), pars[lane])
                st0 = jax.tree_util.tree_map(np.asarray, jk.initial_state())
            finally:
                jops.INTERPRET = False
            runs[lane] = [jk, st0, None]
        if solve and runs[lane][2] is None:
            jops.INTERPRET = lane == "pallas"
            try:
                runs[lane][2] = jsolve(None, pars[lane], kernel=runs[lane][0])
            finally:
                jops.INTERPRET = False
        return runs[lane]

    return get


@pytest.fixture(params=["xla", "pallas"])
def lane(request):
    return request.param


def test_initial_state_matches_jax(lane, jax_runs):
    _, jst, _ = jax_runs(lane, solve=False)
    tst = state_to_numpy(_tkernel(lane).initial_state())
    _compare(tst, jst, 1e-10)


def test_first_direction_matches_jax(lane, jax_runs):
    jk, jst, _ = jax_runs(lane, solve=False)
    tk = _tkernel(lane)
    st = tk.initial_state()
    delta = 1e-8
    jops.INTERPRET = lane == "pallas"
    try:
        jf = jk.form_factor(jst.p, jst.cache, jst.fact)
        jLD, jok = jk.factor(jf.Q, delta)
        jf = jf._replace(L=jLD[0], D=jLD[1], delta=np.float64(delta))
        jd, jr = jk.compute_direction(jf, jst.p, jst.cache, 0.0, 0.0, 0.0)
    finally:
        jops.INTERPRET = False
    tf = tk.form_factor(st.p, st.cache, st.fact)
    _compare(state_to_numpy(tf.Q), jf.Q, 1e-10, "Q")
    # the CUDA kernels take row-major blocks only
    assert all(q.is_contiguous() for q in tf.Q)
    d = torch.full((1,), delta, dtype=torch.float64)
    tLD, tok = tk.factor(tf.Q, d)
    assert bool(jok) and tok.tolist() == [True]
    tf = tf._replace(L=tLD[0], D=tLD[1], delta=d)
    z = torch.zeros(1, dtype=torch.float64)
    td, tr = tk.compute_direction(tf, st.p, st.cache, z, z, z)
    for k in ("x", "y", "s", "mu", "beta"):
        _compare(getattr(td, k).numpy(), np.asarray(getattr(jd, k)), 1e-9, k)
    _compare(tr.numpy(), np.asarray(jr), 1e-9, "kkt_ratio")


def test_run_to_termination_matches_jax(lane, jax_runs):
    _, _, rj = jax_runs(lane)
    tk = _tkernel(lane)
    rt = tsolve(None, tk.pars, kernel=tk)
    assert (rt.status, rt.iterations) == (rj.status, rj.iterations)
    assert rt.status == "Optimal"
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-8)
    mu_j = np.array([h["mu"] for h in rj.history])
    mu_t = np.array([h["mu"] for h in rt.history])
    assert mu_t.shape == mu_j.shape
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-8, atol=0)
    assert [h["t"] for h in rt.history] == [h["t"] for h in rj.history]


def test_chunk_from_carried_jax_state_matches(lane, jax_runs):
    """state_from_numpy carries the JAX chain state (tuple-valued Factor
    fields included); one run_chunk of the port from it ends where the JAX
    package's chunk from the same state ends."""
    _, jst0, rj = jax_runs(lane)
    jend = jax.tree_util.tree_map(np.asarray, rj.state)
    st = state_from_numpy(jst0, device="cpu")
    assert isinstance(st.fact.L, tuple) and isinstance(st.fact.Q, tuple)
    tk = _tkernel(lane)
    end = state_to_numpy(tk.run_chunk(st))
    for k in ("status", "t", "cum_fac", "tot_num_fac"):
        assert int(getattr(end, k)[0]) == int(getattr(jend, k)), k
    _compare(end.p, jend.p, 1e-8, "p")
    # the factor at the last iterate holds y/s ~ 1e8 on the active rows,
    # which amplifies the iterates' last-digit differences
    _compare(end.fact, jend.fact, 1e-6, "fact")


def test_state_holds_no_dense_matrix(lane):
    """Nothing in the chain state is (n, n) or (m, n): the factor is kept in
    (B, K, nb, nb) blocks (n = K nx = 96 here)."""
    tk = _tkernel(lane, dict(K=16, nx=6, mc=3), history_capacity=2)
    st = tk.run_chunk(tk.initial_state())
    n = tk.n
    leaves = [st]
    while leaves:
        v = leaves.pop()
        if isinstance(v, torch.Tensor):
            assert v.numel() < n * n, v.shape
        elif isinstance(v, dict):
            leaves.extend(v.values())
        elif isinstance(v, tuple):
            leaves.extend(v)


def test_direction_matches_port_dense_path(lane):
    """The block-tridiagonal Schur solve against the dense one on the flat
    NLP (tests/test_chain.py:69-97 for the JAX package)."""
    spec = tchain(**SHAPE, device="cpu")
    pars = TParams().with_overrides(_opts(lane))
    ck = TChain(spec, pars, device=CPU)
    gk = OnePhaseKernel(canonicalize(spec.to_nlpspec(), device="cpu"), pars)
    st_c, st_g = ck.initial_state(), gk.initial_state()
    np.testing.assert_allclose(st_c.p.x.numpy(), st_g.p.x.numpy(), atol=1e-9)
    f_c = ck.form_factor(st_c.p, st_c.cache, st_c.fact)
    f_g = gk.form_factor(st_g.p, st_g.cache, st_g.fact)
    np.testing.assert_allclose(f_c.schur_diag.numpy(),
                               f_g.schur_diag.numpy(), atol=1e-8)
    d = torch.full((1,), 1e-8, dtype=torch.float64)
    LD_c, ok_c = ck.factor(f_c.Q, d)
    LD_g, ok_g = gk.factor(f_g.Q, d)
    assert bool(ok_c.all()) and bool(ok_g.all())
    f_c = f_c._replace(L=LD_c[0], D=LD_c[1], delta=d)
    f_g = f_g._replace(L=gk.finalize_solver(LD_g[0]), D=LD_g[1], delta=d)
    z = torch.zeros(1, dtype=torch.float64)
    d_c, r_c = ck.compute_direction(f_c, st_c.p, st_c.cache, z, z, z)
    d_g, _ = gk.compute_direction(f_g, st_g.p, st_g.cache, z, z, z)
    for fld in ("x", "y", "s"):
        a, b = getattr(d_c, fld).numpy(), getattr(d_g, fld).numpy()
        assert np.abs(a - b).max() / (1 + np.abs(a).max()) < 1e-7, fld
    assert float(r_c[0]) < 1e-8


def test_run_matches_port_dense_path(lane):
    """tests/test_chain.py:100-111 on the port: the chain path certifies the
    dense path's argmin in the same number of iterations (within one)."""
    spec = tchain(**SHAPE, device="cpu")
    pars = TParams().with_overrides(_opts(lane, history_capacity=2))
    st = TChain(spec, pars, device=CPU).run_chunk(
        TChain(spec, pars, device=CPU).initial_state())
    assert st.status.tolist() == [OPTIMAL]
    r = tsolve(canonicalize(spec.to_nlpspec(), device="cpu"), pars)
    assert r.status == "Optimal"
    np.testing.assert_allclose(st.p.x[0].numpy(), r.x, atol=1e-5)
    assert abs(int(st.t[0]) - 1 - r.iterations) <= 1


@pytest.mark.parametrize("P", [2, 4, 8])
def test_partitioned_run_matches_sequential(P):
    """Nested dissection (kkt.chain_partitions = P, K = 16) follows the
    sequential block recursion: same outer iterations, x within 1e-7."""
    shape = dict(K=16, nx=6, mc=3)
    seq = _tkernel("xla", shape, history_capacity=2)
    st_seq = seq.run_chunk(seq.initial_state())
    par = _tkernel("xla", shape, history_capacity=2,
                   **{"kkt.chain_partitions": P})
    st_par = par.run_chunk(par.initial_state())
    assert st_par.status.tolist() == [OPTIMAL]
    assert int(st_par.t[0]) == int(st_seq.t[0])
    np.testing.assert_allclose(st_par.p.x.numpy(), st_seq.p.x.numpy(),
                               atol=1e-7)


def test_constructor_checks_like_jax():
    spec = tchain(**SHAPE, device="cpu")

    def make(**over):
        return TChain(spec, TParams().with_overrides(over), device=CPU)

    with pytest.raises(ValueError):
        make(**{"kkt.linear_solver_type": "invchol"})
    with pytest.raises(ValueError):
        make(**{"kkt.linear_solver_type": "pallas",
                "kkt.chain_partitions": 2})
    with pytest.raises(ValueError):
        make(**{"kkt.chain_partitions": 3})
    with pytest.raises(ValueError):
        make(**{"kkt.kkt_solver_type": "symmetric"})
    # a mesh (tests/test_torch_mesh.py) needs partitions, as in the JAX
    # package
    from onephase_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(ValueError, match="chain_partitions > 1"):
        TChain(spec, TParams(), device=CPU,
               mesh=make_mesh(axis="chain", device=CPU))
