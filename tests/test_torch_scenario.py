"""The port's scenario path (parallel/scenario.py, arrow KKT) against the
JAX package's ScenarioKernel, and against the port's own dense path, on
the CPU in float64: the non-mesh cases of tests/test_scenario.py through
both packages.

Problems: two_stage_qp() (K=4, nz=3, nx=4, mc=2: tests/test_scenario.py's),
two_stage_qp(K=16, nz=4, nx=6, mc=3), two_stage_qp(K=64, nz=16, nx=64,
mc=32) (the JAX scale test's shape: first direction only) and
tax_grouped(G=4, na_g=6).  The port's `pallas` lane (K2's plain version
here) and `xla` lane are both held to the JAX `xla` lane: the JAX kernel
factors its blocks with `jnp.linalg.cholesky` on every lane, and its
`pallas` lane stops in `finalize_solver` (ROADMAP R8).

Tolerances: the initial state to 1e-10 and the first direction to 1e-9
of the largest entry; a run to termination with equal status, outer
iterations and factorizations, x to 1e-8 and the per-iteration mu trace to
1e-8 relative; tax_grouped's last mu is round-off-decided in the JAX
package itself (ROADMAP R5) and is held step by step instead.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from onephase_tpu import one_phase_solve as jsolve
from onephase_tpu.config import Params as JParams
from onephase_tpu.models.examples import two_stage_qp as jts
from onephase_tpu.models.tax import tax_grouped as jtg
from onephase_tpu.parallel.scenario import ScenarioKernel as JScen
from onephase_tpu_torch import one_phase_solve as tsolve
from onephase_tpu_torch.config import Params as TParams
from onephase_tpu_torch.interop import state_from_numpy, state_to_numpy
from onephase_tpu_torch.ipm.core import OnePhaseKernel
from onephase_tpu_torch.ipm.state import OPTIMAL
from onephase_tpu_torch.models.examples import two_stage_qp as tts
from onephase_tpu_torch.models.tax import tax_grouped as ttg
from onephase_tpu_torch.nlp import canonicalize
from onephase_tpu_torch.parallel.scenario import ScenarioKernel as TScen
from test_torch_twins import check_carried_steps
from test_torch_twins import compare_states as _compare
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")
OPTS = {"output_level": 0, "term.max_it": 100, "chunk_size": 100}
PROBLEMS = {
    "small": (jts, tts, {}),
    "k16": (jts, tts, dict(K=16, nz=4, nx=6, mc=3)),
    "scale": (jts, tts, dict(K=64, nz=16, nx=64, mc=32)),
    "tax": (jtg, ttg, dict(G=4, na_g=6)),
}


def _tspec(prob):
    _, build, kw = PROBLEMS[prob]
    return build(**kw, device="cpu")


def _tkernel(prob, lane, **extra):
    pars = TParams().with_overrides(
        dict(OPTS, **{"kkt.linear_solver_type": lane}, **extra))
    return TScen(_tspec(prob), pars, device=CPU)


@functools.lru_cache(maxsize=None)
def _jkernel(prob, **extra):
    """The JAX ScenarioKernel of `prob` (one a process and set of options:
    its compiled chunks are shared by the tests that step it)."""
    build, _, kw = PROBLEMS[prob]
    return JScen(build(**kw), JParams().with_overrides(
        dict(OPTS, **{"kkt.linear_solver_type": "xla"}, **extra)))


@pytest.fixture(scope="module")
def jax_runs():
    """Per problem: the JAX kernel, its initial state (numpy leaves) and,
    unless `solve` is False, its solve; computed once."""
    runs = {}

    def get(prob, solve=True):
        if prob not in runs:
            jk = _jkernel(prob)
            st0 = jax.tree_util.tree_map(np.asarray, jk.initial_state())
            runs[prob] = [jk, st0, None]
        if solve and runs[prob][2] is None:
            runs[prob][2] = jsolve(None, runs[prob][0].pars,
                                   kernel=runs[prob][0])
        return runs[prob]

    return get


@pytest.fixture(params=["xla", "pallas"])
def lane(request):
    return request.param


def test_initial_state_matches_jax(lane, jax_runs):
    _, jst, _ = jax_runs("small", solve=False)
    _compare(state_to_numpy(_tkernel("small", lane).initial_state()), jst,
             1e-10)


@pytest.mark.parametrize("prob", ["small", "scale"])
def test_first_direction_matches_jax(prob, lane, jax_runs):
    """Q blocks, the arrow factor at delta 1e-8 and the first affine
    direction (tests/test_scenario.py:24,110 hold the dense twin's; here
    the JAX kernel's own)."""
    jk, jst, _ = jax_runs(prob, solve=False)
    tk = _tkernel(prob, lane)
    st = tk.initial_state()
    _compare(state_to_numpy(st.p), jst.p, 1e-10, "p")
    delta = 1e-8
    jf = jk.form_factor(jst.p, jst.cache, jst.fact)
    jLD, jok = jk.factor(jf.Q, delta)
    jf = jf._replace(L=jLD[0], D=jLD[1], delta=np.float64(delta))
    jd, jr = jk.compute_direction(jf, jst.p, jst.cache, 0.0, 0.0, 0.0)
    tf = tk.form_factor(st.p, st.cache, st.fact)
    _compare(state_to_numpy(tf.Q), jf.Q, 1e-10, "Q")
    _compare(state_to_numpy(tf.schur_diag), jf.schur_diag, 1e-10, "diag")
    # the K2 kernel takes row-major blocks only
    assert all(q.is_contiguous() for q in tf.Q)
    d = torch.full((1,), delta, dtype=torch.float64)
    tLD, tok = tk.factor(tf.Q, d)
    assert bool(jok) and tok.tolist() == [True]
    _compare(state_to_numpy(tLD[0]), jLD[0], 1e-10, "L")
    tf = tf._replace(L=tLD[0], D=tLD[1], delta=d)
    z = torch.zeros(1, dtype=torch.float64)
    td, tr = tk.compute_direction(tf, st.p, st.cache, z, z, z)
    for k in ("x", "y", "s", "mu", "beta"):
        _compare(getattr(td, k).numpy(), np.asarray(getattr(jd, k)), 1e-9, k)
    _compare(tr.numpy(), np.asarray(jr), 1e-9, "kkt_ratio")
    assert float(tr[0]) < 1e-8


def _check_run(rt, rj, mu_upto=None):
    assert (rt.status, rt.iterations) == (rj.status, rj.iterations)
    assert int(rt.state.cum_fac[0]) == int(rj.state.cum_fac)
    assert rt.status == "Optimal"
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-8)
    mu_j = np.array([h["mu"] for h in rj.history])
    mu_t = np.array([h["mu"] for h in rt.history])
    assert mu_t.shape == mu_j.shape
    np.testing.assert_allclose(mu_t[:mu_upto], mu_j[:mu_upto], rtol=1e-8,
                               atol=0)
    assert [h["t"] for h in rt.history] == [h["t"] for h in rj.history]


@pytest.mark.parametrize("prob", ["small", "k16"])
def test_run_to_termination_matches_jax(prob, lane, jax_runs):
    _, _, rj = jax_runs(prob)
    tk = _tkernel(prob, lane)
    _check_run(tsolve(None, tk.pars, kernel=tk), rj)


def test_tax_grouped_matches_jax(lane, jax_runs):
    """The ECON-style block-angular model (tests/test_scenario.py:151):
    status, outer iterations, factorizations and argmin equal; the mu trace
    to 1e-8 but its last entry, which the JAX package's own arrow and dense
    runs put 1.3e-6 apart (ROADMAP R5).  Every step before it is held
    from the JAX package's own state to 1e-10; the last is not, as the JAX
    package's a-posteriori KKT ratio there is 2.3e-9 (`ratio_cap`)."""
    _, _, rj = jax_runs("tax")
    tk = _tkernel("tax", lane)
    _check_run(tsolve(None, tk.pars, kernel=tk), rj, mu_upto=-1)
    steps = check_carried_steps(
        None, None, ratio_cap=1e-10,
        kernels=(_jkernel("tax", chunk_size=1),
                 _tkernel("tax", lane, chunk_size=1)))
    assert steps == rj.iterations - 1


def test_chunk_from_carried_jax_state_matches(lane, jax_runs):
    """state_from_numpy carries the JAX scenario state (the tuple factors
    (Jx, Jz), (Hzz, Hkk, Hkz), (Qzz, Qkk, Bk) and (Lk, LS)); one run_chunk
    of the port from it ends where the JAX package's chunk ends."""
    _, jst0, rj = jax_runs("small")
    jend = jax.tree_util.tree_map(np.asarray, rj.state)
    st = state_from_numpy(jst0, device="cpu")
    assert [len(getattr(st.fact, k)) for k in ("Jc", "H", "Q", "L")] == \
        [2, 3, 3, 2]
    assert st.fact.L[0].shape == (1, 4, 4, 4)
    end = state_to_numpy(_tkernel("small", lane).run_chunk(st))
    for k in ("status", "t", "cum_fac", "tot_num_fac"):
        assert int(getattr(end, k)[0]) == int(getattr(jend, k)), k
    _compare(end.p, jend.p, 1e-8, "p")
    _compare(end.fact, jend.fact, 1e-6, "fact")


def test_state_holds_no_dense_matrix(lane):
    """Nothing in the scenario state is (n, n) or (m, n): the factor is
    kept in scenario blocks and the border (n = 4 + 16 * 6 = 100 here)."""
    tk = _tkernel("k16", lane, history_capacity=2)
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


def _dense_twin(prob, pars):
    return OnePhaseKernel(canonicalize(_tspec(prob).to_nlpspec(),
                                       device="cpu"), pars)


def test_direction_matches_port_dense_path(lane):
    """The arrow Schur solve against the dense one on the flat NLP
    (tests/test_scenario.py:24-55 for the JAX package)."""
    sk = _tkernel("small", lane)
    gk = _dense_twin("small", sk.pars)
    st_s, st_g = sk.initial_state(), gk.initial_state()
    np.testing.assert_allclose(st_s.p.x.numpy(), st_g.p.x.numpy(), atol=1e-9)
    np.testing.assert_allclose(st_s.p.y.numpy(), st_g.p.y.numpy(), atol=1e-9)
    f_s = sk.form_factor(st_s.p, st_s.cache, st_s.fact)
    f_g = gk.form_factor(st_g.p, st_g.cache, st_g.fact)
    np.testing.assert_allclose(f_s.schur_diag.numpy(),
                               f_g.schur_diag.numpy(), atol=1e-8)
    d = torch.full((1,), 1e-8, dtype=torch.float64)
    LD_s, ok_s = sk.factor(f_s.Q, d)
    LD_g, ok_g = gk.factor(f_g.Q, d)
    assert bool(ok_s.all()) and bool(ok_g.all())
    f_s = f_s._replace(L=LD_s[0], D=LD_s[1], delta=d)
    f_g = f_g._replace(L=gk.finalize_solver(LD_g[0]), D=LD_g[1], delta=d)
    z = torch.zeros(1, dtype=torch.float64)
    d_s, r_s = sk.compute_direction(f_s, st_s.p, st_s.cache, z, z, z)
    d_g, _ = gk.compute_direction(f_g, st_g.p, st_g.cache, z, z, z)
    for fld in ("x", "y", "s"):
        a, b = getattr(d_s, fld).numpy(), getattr(d_g, fld).numpy()
        assert np.abs(a - b).max() / (1 + np.abs(a).max()) < 1e-7, fld
    assert float(r_s[0]) < 1e-8


@pytest.mark.parametrize("prob", ["small", "tax"])
def test_run_matches_port_dense_path(prob, lane):
    """tests/test_scenario.py:58-72 and :151-171 on the port: the arrow
    path certifies the dense path's argmin in the same number of outer
    iterations (within one)."""
    sk = _tkernel(prob, lane, history_capacity=2)
    st = sk.run_chunk(sk.initial_state())
    assert st.status.tolist() == [OPTIMAL]
    r = tsolve(canonicalize(_tspec(prob).to_nlpspec(), device="cpu"),
               sk.pars)
    assert r.status == "Optimal"
    np.testing.assert_allclose(st.p.x[0].numpy(), r.x, atol=1e-5)
    assert abs(int(st.t[0]) - 1 - r.iterations) <= 1


def test_constructor_checks_like_jax():
    spec = _tspec("small")

    def make(**over):
        return TScen(spec, TParams().with_overrides(over), device=CPU)

    with pytest.raises(ValueError):
        make(**{"kkt.kkt_solver_type": "symmetric"})
    with pytest.raises(ValueError):
        make(**{"kkt.linear_solver_type": "invchol"})
    # a mesh (tests/test_torch_mesh.py) needs its scenario axis
    from onephase_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(ValueError, match="mesh has no axis 'blk'"):
        TScen(spec, TParams(), device=CPU,
              mesh=make_mesh(axis="dp", device=CPU))
    # the JAX package runs "eigh" as its xla lane on this path
    assert not make(**{"kkt.linear_solver_type": "eigh"}).use_pallas
