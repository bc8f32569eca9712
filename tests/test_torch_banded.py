"""The port's RCM-banded path (parallel/banded.py) against the JAX package's
BandedKernel, on the CPU in float64: every case of tests/test_banded.py
except the mesh one, each run through both packages from the same numpy
data.

chain_ocp(K=8, nx=6, mc=3).to_nlpspec() (n = 48; RCM bandwidth 11, so 5
blocks of 11 with an identity tail of 7), K=16 for the partitioned runs, on
the `xla` and `pallas` lanes (the JAX package runs its Pallas solve in
interpret mode), assembled and matrix-free.  Tolerances: `schur_diag`, the
band blocks and the first direction to 1e-8 of the largest entry; the run
to termination with equal status and outer-iteration count, x to 1e-6 and
the per-iteration mu trace to 1e-8 relative.  Both packages order with
their C++ RCM (the numpy route breaks ties differently; one test runs both
packages on it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onephase_tpu.native as jnative
import onephase_tpu.ops as jops
from onephase_tpu import one_phase_solve as jsolve
from onephase_tpu.config import Params as JParams
from onephase_tpu.models.examples import chain_ocp as jchain
from onephase_tpu.nlp import NLPSpec as JSpec
from onephase_tpu.nlp import canonicalize as jcanon
from onephase_tpu.parallel.banded import BandedKernel as JBanded
from onephase_tpu_torch import native as tnative
from onephase_tpu_torch import one_phase_solve as tsolve
from onephase_tpu_torch.config import Params as TParams
from onephase_tpu_torch.interop import state_from_numpy, state_to_numpy
from onephase_tpu_torch.ipm.core import OnePhaseKernel
from onephase_tpu_torch.ipm.state import OPTIMAL
from onephase_tpu_torch.models.examples import chain_ocp as tchain
from onephase_tpu_torch.nlp import NLPSpec as TSpec
from onephase_tpu_torch.nlp import canonicalize as tcanon
from onephase_tpu_torch.parallel.banded import BandedKernel as TBanded
from test_torch_twins import assert_close
from test_torch_twins import compare_states as _compare

SHAPE = dict(K=8, nx=6, mc=3)
OPTS = {"output_level": 0, "term.max_it": 100, "chunk_size": 100}
F64 = torch.float64


def _opts(lane, **extra):
    return dict(OPTS, **{"kkt.linear_solver_type": lane}, **extra)


def _tnlp(shape=SHAPE):
    return tcanon(tchain(**shape, device="cpu").to_nlpspec(), device="cpu")


def _tkernel(lane, matrix_free=False, shape=SHAPE, nlp=None, **extra):
    return TBanded(nlp if nlp is not None else _tnlp(shape),
                   TParams().with_overrides(_opts(lane, **extra)),
                   matrix_free=matrix_free, device="cpu")


class _Interpret:
    """The JAX package's Pallas solve runs in interpret mode off the TPU."""

    def __init__(self, lane):
        self.on = lane == "pallas"

    def __enter__(self):
        jops.INTERPRET = self.on

    def __exit__(self, *exc):
        jops.INTERPRET = False


@pytest.fixture(scope="module")
def jax_runs():
    """Per (lane, matrix_free): the JAX kernel, its initial state (numpy
    leaves) and its solve, computed once."""
    runs = {}

    def get(lane, matrix_free):
        key = (lane, matrix_free)
        if key not in runs:
            with _Interpret(lane):
                pars = JParams().with_overrides(_opts(lane))
                jk = JBanded(jcanon(jchain(**SHAPE).to_nlpspec()), pars,
                             matrix_free=matrix_free)
                st0 = jax.tree_util.tree_map(np.asarray, jk.initial_state())
                res = jsolve(None, pars, kernel=jk)
            runs[key] = (jk, st0, res)
        return runs[key]

    return get


@pytest.fixture(params=["xla", "pallas"])
def lane(request):
    return request.param


@pytest.fixture(params=[False, True], ids=["assembled", "matrix_free"])
def matrix_free(request):
    return request.param


def _first_direction(k, st, delta, scalar):
    """form_factor -> factor at `delta` -> the affine direction."""
    f = k.form_factor(st.p, st.cache, st.fact)
    LD, ok = k.factor(f.Q, delta)
    f = f._replace(L=LD[0], D=LD[1], delta=delta)
    d, r = k.compute_direction(f, st.p, st.cache, scalar, scalar, scalar)
    return f, ok, d, r


def test_routes_and_layout_match_jax(jax_runs):
    """Both packages order with the C++ RCM here and find the same
    permutation, bandwidth and block layout."""
    jk, _, _ = jax_runs("xla", False)
    tk = _tkernel("xla")
    assert tnative.route() == "native" and jnative.get_lib() is not None
    np.testing.assert_array_equal(tk.perm, jk.perm)
    np.testing.assert_array_equal(tk.iperm, jk.iperm)
    assert (tk.bandwidth, tk.nb, tk.K, tk.n_pad) == (
        jk.bandwidth, jk.nb, jk.K, jk.n_pad) == (11, 11, 5, 55)
    assert tk.bandwidth < tk.n // 2


def test_initial_state_matches_jax(lane, matrix_free, jax_runs):
    _, jst, _ = jax_runs(lane, matrix_free)
    tst = state_to_numpy(_tkernel(lane, matrix_free).initial_state())
    _compare(tst, jst, 1e-10)


def test_first_direction_matches_jax_and_dense(lane, matrix_free, jax_runs):
    """tests/test_banded.py::test_banded_direction_matches_dense through
    both packages: schur_diag, the band blocks and the direction against
    the JAX BandedKernel, and against the port's own dense kernel."""
    jk, jst, _ = jax_runs(lane, matrix_free)
    tk = _tkernel(lane, matrix_free)
    st = tk.initial_state()
    with _Interpret(lane):
        jf, jok, jd, jr = _first_direction(jk, jst, np.float64(1e-8), 0.0)
    delta = torch.full((1,), 1e-8, dtype=F64)
    z = torch.zeros(1, dtype=F64)
    tf, tok, td, tr = _first_direction(tk, st, delta, z)
    assert bool(jok) and tok.tolist() == [True]
    _compare(state_to_numpy(tf.schur_diag), jf.schur_diag, 1e-8, "schur_diag")
    _compare(state_to_numpy(tf.Q), jf.Q, 1e-8, "Q")
    # the CUDA kernels take row-major blocks only
    assert all(q.is_contiguous() for q in tf.Q)
    for k in ("x", "y", "s", "mu", "beta"):
        _compare(getattr(td, k).numpy(), np.asarray(getattr(jd, k)), 1e-8, k)
    assert float(tr[0]) < 1e-8 and float(jr) < 1e-8

    gk = OnePhaseKernel(tk.nlp, tk.pars)
    sg = gk.initial_state()
    fg = gk.form_factor(sg.p, sg.cache, sg.fact)
    np.testing.assert_allclose(tf.schur_diag.numpy(), fg.schur_diag.numpy(),
                               atol=1e-8)
    LDg, okg = gk.factor(fg.Q, delta)
    fg = fg._replace(L=gk.finalize_solver(LDg[0]), D=LDg[1], delta=delta)
    dg, _ = gk.compute_direction(fg, sg.p, sg.cache, z, z, z)
    for fld in ("x", "y", "s"):
        a, b = getattr(td, fld).numpy(), getattr(dg, fld).numpy()
        assert np.abs(a - b).max() / (1 + np.abs(a).max()) < 1e-7, fld


def test_run_to_termination_matches_jax(lane, matrix_free, jax_runs):
    """test_banded_end_to_end_matches_dense and
    test_matrix_free_end_to_end_matches_dense through both packages."""
    _, _, rj = jax_runs(lane, matrix_free)
    tk = _tkernel(lane, matrix_free)
    rt = tsolve(None, tk.pars, kernel=tk)
    assert (rt.status, rt.iterations) == (rj.status, rj.iterations)
    assert rt.status == "Optimal"
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-6)
    mu_j = np.array([h["mu"] for h in rj.history])
    mu_t = np.array([h["mu"] for h in rt.history])
    assert mu_t.shape == mu_j.shape
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-8, atol=0)
    assert [h["t"] for h in rt.history] == [h["t"] for h in rj.history]
    # and the port's dense path certifies the same argmin
    rd = tsolve(tk.nlp, tk.pars)
    assert rd.status == "Optimal"
    np.testing.assert_allclose(rt.x, rd.x, atol=1e-5)
    assert abs(rt.iterations - rd.iterations) <= 1


def test_matrix_free_band_matches_assembled(lane):
    """The probed (Qd, Qs) equals the assembled band, and the Factor's
    slots hold the linearization point, not matrices."""
    bk, mk = _tkernel(lane), _tkernel(lane, matrix_free=True)
    sb, sm = bk.initial_state(), mk.initial_state()
    fb = bk.form_factor(sb.p, sb.cache, sb.fact)
    fm = mk.form_factor(sm.p, sm.cache, sm.fact)
    np.testing.assert_allclose(fm.Q[0].numpy(), fb.Q[0].numpy(), atol=1e-8)
    np.testing.assert_allclose(fm.Q[1].numpy(), fb.Q[1].numpy(), atol=1e-8)
    assert fm.Jc.shape == (1, mk.n) and fm.H.shape == (1,)
    assert fb.Jc.shape == (1, bk.nlp.m_orig, bk.n)
    assert fb.H.shape == (1, bk.n, bk.n)
    assert all(q.is_contiguous() for q in fm.Q)


def test_chunk_from_carried_jax_state_matches(lane, matrix_free, jax_runs):
    """state_from_numpy carries the JAX banded state (tuple Q and L; in
    matrix-free mode the Jc slot holding x and the H slot holding mu); one
    run_chunk of the port from it ends where the JAX package's ends."""
    _, jst0, rj = jax_runs(lane, matrix_free)
    jend = jax.tree_util.tree_map(np.asarray, rj.state)
    st = state_from_numpy(jst0, device="cpu")
    assert isinstance(st.fact.L, tuple) and isinstance(st.fact.Q, tuple)
    tk = _tkernel(lane, matrix_free)
    if matrix_free:
        assert st.fact.Jc.shape == (1, tk.n) and st.fact.H.shape == (1,)
    end = state_to_numpy(tk.run_chunk(st))
    for k in ("status", "t", "cum_fac", "tot_num_fac"):
        assert int(getattr(end, k)[0]) == int(getattr(jend, k)), k
    _compare(end.p, jend.p, 1e-8, "p")
    # the factor at the last iterate holds y/s ~ 1e8 on the active rows,
    # which amplifies the iterates' last-digit differences
    _compare(end.fact, jend.fact, 1e-6, "fact")


@pytest.mark.parametrize("P", [2, 4])
def test_partitioned_run_matches_sequential_and_jax(P):
    """test_banded_partitioned_matches_sequential through both packages
    (K = 16: 9 blocks of 11, padded to P * Kc)."""
    shape = dict(K=16, nx=6, mc=3)
    nlp = _tnlp(shape)
    seq = _tkernel("xla", nlp=nlp, history_capacity=2)
    st_seq = seq.run_chunk(seq.initial_state())
    par = _tkernel("xla", nlp=nlp, history_capacity=2,
                   **{"kkt.chain_partitions": P})
    st_par = par.run_chunk(par.initial_state())
    assert st_par.status.tolist() == [OPTIMAL]
    assert int(st_par.t[0]) == int(st_seq.t[0])
    np.testing.assert_allclose(st_par.p.x.numpy(), st_seq.p.x.numpy(),
                               atol=1e-7)
    jk = JBanded(jcanon(jchain(**shape).to_nlpspec()),
                 JParams().with_overrides(_opts(
                     "xla", history_capacity=2,
                     **{"kkt.chain_partitions": P})))
    jst = jk.run_chunk(jk.initial_state())
    assert (par.K, par.nb) == (jk.K, jk.nb)
    assert int(st_par.status[0]) == int(jst.status)
    assert int(st_par.t[0]) == int(jst.t)
    np.testing.assert_allclose(st_par.p.x[0].numpy(), np.asarray(jst.p.x),
                               atol=1e-6)


def _scrambled(seed=7):
    """The chain NLP with randomly permuted variable order, in both
    packages: the natural band is destroyed, so a small bandwidth exists
    only if RCM finds it."""
    jspec = jchain(**SHAPE).to_nlpspec()
    tspec = tchain(**SHAPE, device="cpu").to_nlpspec()
    n = len(np.asarray(jspec.x0))
    sig = np.random.default_rng(seed).permutation(n)
    inv = np.argsort(sig)
    sig_t = torch.as_tensor(sig)

    def bounds(spec):
        return dict(lcon=spec.lcon, ucon=spec.ucon,
                    lvar=np.asarray(spec.lvar)[inv],
                    uvar=np.asarray(spec.uvar)[inv],
                    x0=np.asarray(spec.x0)[inv], name="scrambled_chain")

    jn = jcanon(JSpec(f=lambda z: jspec.f(z[jnp.asarray(sig)]),
                      c=lambda z: jspec.c(z[jnp.asarray(sig)]),
                      **bounds(jspec)))
    tn = tcanon(TSpec(f=lambda z: tspec.f(z[sig_t]),
                      c=lambda z: tspec.c(z[sig_t]), **bounds(tspec)),
                device="cpu")
    return jn, tn


def test_rcm_recovers_band_from_scrambled_order():
    """test_rcm_recovers_band_from_scrambled_order through both packages:
    the detected pattern, the C++ RCM permutation and the bandwidth equal
    the JAX package's, far below n, and the solve follows its trajectory."""
    jn, tn = _scrambled()
    pars = JParams().with_overrides(_opts("xla"))
    jk = JBanded(jn, pars)
    tk = _tkernel("xla", nlp=tn)
    assert tnative.route() == "native" and jnative.get_lib() is not None
    np.testing.assert_array_equal(tk.perm, jk.perm)
    assert tk.bandwidth == jk.bandwidth and tk.bandwidth < tn.n // 2
    rj = jsolve(None, pars, kernel=jk)
    rt = tsolve(None, tk.pars, kernel=tk)
    assert (rt.status, rt.iterations) == (rj.status, rj.iterations)
    assert rt.status == "Optimal"
    np.testing.assert_allclose(rt.x, rj.x, atol=1e-6)
    rd = tsolve(tn, tk.pars)
    np.testing.assert_allclose(rt.x, rd.x, atol=1e-5)


def test_numpy_route_matches_jax(monkeypatch):
    """Without the C++ library both packages fall back to the same numpy
    breadth-first search; on a pattern with degree ties it need not equal
    the C++ ordering, so it is compared route against route."""
    blk = np.arange(48) // 6
    pattern = np.abs(blk[:, None] - blk[None, :]) <= 1
    sig = np.random.default_rng(3).permutation(48)
    pattern = pattern[sig][:, sig]
    native_perm = tnative.rcm_order(pattern)
    np.testing.assert_array_equal(native_perm, jnative.rcm_order(pattern))
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    assert tnative.route() == "numpy"
    perm = tnative.rcm_order(pattern)
    np.testing.assert_array_equal(perm, jnative.rcm_order(pattern))
    assert sorted(perm.tolist()) == list(range(48))
    ii, jj = np.nonzero(pattern[perm][:, perm])
    assert np.abs(ii - jj).max() < 24
    J = np.random.default_rng(0).normal(size=(6, 5))
    J[4] = -2.0 * J[1]
    for got, want in zip(tnative.detect_parallel_rows(J),
                         jnative.detect_parallel_rows(J)):
        np.testing.assert_array_equal(got, want)


def test_detect_parallel_rows_matches_jax():
    J = np.random.default_rng(0).normal(size=(7, 5))
    J[J < -0.8] = 0.0
    J[4] = -2.0 * J[1]
    J[6] = 0.5 * J[2]
    got = tnative.detect_parallel_rows(J)
    want = jnative.detect_parallel_rows(J)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2] == 2 and got[0][4] == 1 and got[1][4] == -2.0


def test_batch_of_two_starts(lane, matrix_free):
    """B = 2 with distinct starts: every instance equals its own single
    solve (the batch axis is carried through the band gather, the probes
    and the permuted solves)."""
    tk = _tkernel(lane, matrix_free, history_capacity=2)
    rng = np.random.default_rng(5)
    x0 = torch.as_tensor(rng.uniform(-1.0, 1.0, size=(2, tk.n)))
    st2 = tk.initial_state_from(x0)
    f2 = tk.form_factor(st2.p, st2.cache, st2.fact)
    singles = [tk.initial_state_from(x0[b:b + 1]) for b in range(2)]
    for b, st1 in enumerate(singles):
        f1 = tk.form_factor(st1.p, st1.cache, st1.fact)
        for got, want in zip(f2.Q + (f2.schur_diag,), f1.Q + (f1.schur_diag,)):
            assert_close(got[b].numpy(), want[0].numpy(), 1e-12, "Q")
    assert float((f2.Q[0][0] - f2.Q[0][1]).abs().max()) > 1e-3
    end2 = tk.run_chunk(st2)
    assert end2.status.tolist() == [OPTIMAL, OPTIMAL]
    for b, st1 in enumerate(singles):
        end1 = tk.run_chunk(st1)
        assert int(end2.t[b]) == int(end1.t[0])
        np.testing.assert_allclose(end2.p.x[b].numpy(), end1.p.x[0].numpy(),
                                   atol=1e-8)


def test_matrix_free_never_forms_dense_j_or_h(monkeypatch):
    """Matrix-free mode with a supplied pattern evaluates no dense Jacobian
    or Hessian: not at construction (even when the spec declares constant
    structure, which the assembled mode would fold), not in a solve; and
    no tensor of the state has n * n entries."""
    spec = tchain(K=16, nx=6, mc=3, device="cpu").to_nlpspec()
    spec.constant_jac = True
    nlp = tcanon(spec, device="cpu")
    blk = np.arange(nlp.n) // 6
    pattern = np.abs(blk[:, None] - blk[None, :]) <= 1

    def boom(*a, **k):
        raise AssertionError("a dense J or H was evaluated")

    monkeypatch.setattr(nlp, "jac_orig", boom)
    monkeypatch.setattr(nlp, "lag_hess", boom)
    tk = TBanded(nlp, TParams().with_overrides(
        _opts("pallas", history_capacity=2)), matrix_free=True,
        pattern=pattern, device="cpu")
    assert tk._Jc_const is None and tk._H_const is None
    st = tk.run_chunk(tk.initial_state())
    assert st.status.tolist() == [OPTIMAL]
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
    # the assembled mode on the same spec folds the constant Jacobian
    monkeypatch.undo()
    ak = TBanded(nlp, tk.pars, pattern=pattern, device="cpu")
    assert ak._Jc_const is not None
    sa = ak.run_chunk(ak.initial_state())
    assert int(sa.t[0]) == int(st.t[0])
    np.testing.assert_allclose(sa.p.x.numpy(), st.p.x.numpy(), atol=1e-8)


def test_block_size_override_and_pattern_checks():
    nlp = _tnlp()
    pars = TParams().with_overrides(_opts("xla", history_capacity=2))
    wide = TBanded(nlp, pars, block_size=16, device="cpu")
    assert (wide.nb, wide.K, wide.n_pad, wide.bandwidth) == (16, 3, 48, 11)
    st = wide.run_chunk(wide.initial_state())
    ref = _tkernel("xla", nlp=nlp, history_capacity=2)
    sr = ref.run_chunk(ref.initial_state())
    assert st.status.tolist() == [OPTIMAL] and int(st.t[0]) == int(sr.t[0])
    np.testing.assert_allclose(st.p.x.numpy(), sr.p.x.numpy(), atol=1e-8)
    with pytest.raises(ValueError, match="RCM bandwidth"):
        TBanded(nlp, pars, block_size=5, device="cpu")
    with pytest.raises(ValueError, match="pattern has shape"):
        TBanded(nlp, pars, pattern=np.eye(3, dtype=bool), device="cpu")


def test_constructor_checks_like_jax():
    nlp = _tnlp()

    def make(matrix_free=False, **over):
        return TBanded(nlp, TParams().with_overrides(over),
                       matrix_free=matrix_free, device="cpu")

    with pytest.raises(ValueError):
        make(**{"kkt.linear_solver_type": "invchol"})
    with pytest.raises(ValueError):
        make(**{"kkt.linear_solver_type": "pallas",
                "kkt.chain_partitions": 2})
    with pytest.raises(ValueError):
        make(**{"kkt.kkt_solver_type": "symmetric"})
    with pytest.raises(ValueError):
        make(matrix_free=True, **{"kkt.linear_solver_type": "xla",
                                  "kkt.it_refine_highprec": True})
    with pytest.raises(NotImplementedError):
        TBanded(nlp, TParams().with_overrides(_opts("xla")), device="cpu",
                mesh=object())
    # sample_pdata is ported (tests/test_torch_parametric.py); on a
    # problem that is not parametric the JAX kernel ignores it, and so does
    # the port's
    base = TBanded(nlp, TParams().with_overrides(_opts("xla")), device="cpu")
    sampled = TBanded(nlp, TParams().with_overrides(_opts("xla")),
                      device="cpu", sample_pdata={"p": np.zeros(1)})
    assert (sampled.perm == base.perm).all()
    assert sampled.bandwidth == base.bandwidth
    with pytest.raises(ValueError, match="lives on"):
        TBanded(nlp, TParams().with_overrides(_opts("xla")), device="meta")
