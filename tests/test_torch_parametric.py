"""Parametric problems (`NLPSpec.pdata`) and the user Jacobian oracle
(`NLPSpec.jac`) in the port against the JAX package, float64 on the CPU:
single solves on the template data, batches of three instances each with
its own A (BatchSolver.init(pdata=)), the parametric constant-Jacobian
branch (Jc evaluated once per solve and carried per instance), and the
banded kernel's pattern from `sample_pdata`.  Status, outer iterations, x
to 1e-8 and the mu trace to 1e-8 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onephase_tpu.nlp as jnlp
import onephase_tpu.ops as jops
import onephase_tpu_torch.nlp as tnlp
from onephase_tpu.config import Params as JParams
from onephase_tpu.parallel.batch import BatchSolver as JBatch
from onephase_tpu_torch.config import Params as TParams
from onephase_tpu_torch.ipm.history import IDX
from onephase_tpu_torch.parallel.batch import BatchSolver as TBatch
from test_torch_twins import check_solve_parity, jax_solve, port_solve
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, M, B = 6, 3, 3
OPTS = {"output_level": 0, "term.max_it": 81, "history_capacity": 100}


def _data(seed=0):
    """One template instance and a batch of B, from one numpy draw."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, M, N))
    c = rng.normal(size=(B, N))
    t = rng.normal(size=(B, N))
    x0 = rng.normal(size=(B, N)) * 0.1
    return {"A": A, "c": c, "t": t}, x0


def _spec_pair(kind):
    """(JAX spec, port spec) of one parametric problem, template data the
    batch's instance 0.  "linear_jac": c = A x with the user Jacobian and
    constant J/H declared (the parametric constant branch); "nonlinear":
    c = A x + 0.1 x[:m]^2, no Jacobian oracle (autodiff through the
    instance's data every iteration)."""
    pd, x0 = _data()
    template = {k: v[0] for k, v in pd.items()}
    common = dict(lcon=np.full(M, -1.0), ucon=np.full(M, 1.0),
                  lvar=np.full(N, -5.0), uvar=np.full(N, 5.0), x0=x0[0],
                  name=f"param_{kind}")
    if kind == "linear_jac":
        common.update(lin=tuple(range(M)), constant_jac=True,
                      constant_hess=True)
        jspec = jnlp.NLPSpec(
            f=lambda x, p: 0.5 * jnp.sum((x - p["t"]) ** 2) + p["c"] @ x,
            c=lambda x, p: p["A"] @ x, jac=lambda x, p: p["A"],
            pdata=template, **common)
        tspec = tnlp.NLPSpec(
            f=lambda x, p: 0.5 * torch.sum((x - p["t"]) ** 2) + p["c"] @ x,
            c=lambda x, p: p["A"] @ x, jac=lambda x, p: p["A"],
            pdata=template, **common)
    else:
        jspec = jnlp.NLPSpec(
            f=lambda x, p: 0.5 * jnp.sum((x - p["t"]) ** 2) + p["c"] @ x,
            c=lambda x, p: p["A"] @ x + 0.1 * x[:M] ** 2,
            pdata=template, **common)
        tspec = tnlp.NLPSpec(
            f=lambda x, p: 0.5 * torch.sum((x - p["t"]) ** 2) + p["c"] @ x,
            c=lambda x, p: p["A"] @ x + 0.1 * x[:M] ** 2,
            pdata=template, **common)
    return jspec, tspec


@pytest.mark.parametrize("kind", ["linear_jac", "nonlinear"])
@pytest.mark.parametrize("lane", ["xla", "pallas"])
def test_single_solve_matches_jax(kind, lane):
    jspec, tspec = _spec_pair(kind)
    rj = jax_solve(jspec, OPTS, lane)
    rt = port_solve(tspec, OPTS, lane)
    assert rj.status == "Optimal"
    check_solve_parity(rt, rj, x_tol=1e-8, mu_rtol=1e-8)


def _mu_traces(st):
    buf = np.asarray(st.hist.buf if not isinstance(st.hist.buf, torch.Tensor)
                     else st.hist.buf.numpy())
    cnt = np.asarray(st.hist.count)
    return [buf[b, :cnt[b], IDX["mu"]] for b in range(buf.shape[0])]


@pytest.fixture(scope="module")
def batch_runs():
    """Both packages' batches of B instances (own A, c, t each) on the
    pallas lane (the JAX package's under vmap: its XLA twins, R2)."""
    out = {}
    pd, x0 = _data()
    for kind in ("linear_jac", "nonlinear"):
        jspec, tspec = _spec_pair(kind)
        opts = dict(OPTS, **{"kkt.linear_solver_type": "pallas"})
        jops.INTERPRET = True
        try:
            js = JBatch(jnlp.canonicalize(jspec, dtype=jnp.float64),
                        JParams().with_overrides(opts))
            jst = js.solve(x0, pdata={k: jnp.asarray(v)
                                      for k, v in pd.items()})
        finally:
            jops.INTERPRET = False
        ts = TBatch(tnlp.canonicalize(tspec, device="cpu"),
                    TParams().with_overrides(opts))
        tst = ts.solve(x0, pdata=pd)
        out[kind] = (js, jst, ts, tst)
    return out


@pytest.mark.parametrize("kind", ["linear_jac", "nonlinear"])
def test_batch_matches_jax(kind, batch_runs):
    js, jst, ts, tst = batch_runs[kind]
    assert ts.statuses(tst) == js.statuses(jst)
    assert "Optimal" in js.statuses(jst)
    np.testing.assert_array_equal(tst.t.numpy(), np.asarray(jst.t))
    np.testing.assert_array_equal(tst.cum_fac.numpy(), np.asarray(jst.cum_fac))
    np.testing.assert_allclose(tst.p.x.numpy(), np.asarray(jst.p.x),
                               rtol=0, atol=1e-8)
    for mt, mj in zip(_mu_traces(tst), _mu_traces(jst)):
        np.testing.assert_allclose(mt, mj, rtol=1e-8, atol=0)
    # the instances differ: their data, not just their starts
    assert len({round(float(v), 6) for v in tst.cache.fval}) == B


def test_batch_instances_equal_their_single_solves(batch_runs):
    """Each instance of the parametric batch equals a batch of one with
    that instance's data."""
    _, _, ts, tst = batch_runs["nonlinear"]
    pd, x0 = _data()
    for b in range(B):
        s1 = ts.solve(x0[b:b + 1], pdata={k: v[b:b + 1] for k, v in pd.items()})
        assert int(s1.status[0]) == int(tst.status[b])
        assert int(s1.t[0]) == int(tst.t[b])
        np.testing.assert_allclose(s1.p.x[0].numpy(), tst.p.x[b].numpy(),
                                   rtol=0, atol=1e-12)


def test_param_const_jac_branch(batch_runs):
    """constant_jac on a parametric problem: the Jacobian is not folded
    into the kernel but evaluated once per solve and carried per instance
    in Factor.Jc, (B, m, n), equal to each instance's A (the user oracle's
    matrix) and to the JAX package's carried Jc; H likewise."""
    js, jst, ts, tst = batch_runs["linear_jac"]
    k = ts.kernel
    assert k._param_const_jac and k._param_const_hess
    assert k._Jc_const is None and k._H_const is None
    assert js.kernel._param_const_jac and js.kernel._param_const_hess
    pd, _ = _data()
    np.testing.assert_array_equal(tst.fact.Jc.numpy(), pd["A"])
    np.testing.assert_array_equal(np.asarray(jst.fact.Jc), pd["A"])
    np.testing.assert_allclose(tst.fact.H.numpy(), np.asarray(jst.fact.H),
                               rtol=0, atol=1e-14)
    np.testing.assert_array_equal(tst.fact.H.numpy(),
                                  np.broadcast_to(np.eye(N), (B, N, N)))
    # the nonlinear problem declares nothing: no carried constant
    kn = batch_runs["nonlinear"][2].kernel
    assert not (kn._param_const_jac or kn._param_const_hess)


def test_user_jacobian_oracle_bypasses_autodiff():
    """With `jac` given, jac_orig returns the oracle's matrix (in the
    reduced space after fixed-variable elimination), not c's derivative."""
    A = np.arange(6.0).reshape(2, 3)
    kw = dict(lcon=[-1.0, -1.0], ucon=[1.0, 1.0], lvar=[0.0, 2.0, 0.0],
              uvar=[1.0, 2.0, 1.0], x0=[0.5, 2.0, 0.5])
    jspec = jnlp.NLPSpec(f=lambda x: jnp.sum(x), c=lambda x: 0.0 * x[:2],
                         jac=lambda x: jnp.asarray(A), **kw)
    tspec = tnlp.NLPSpec(f=lambda x: torch.sum(x), c=lambda x: 0.0 * x[:2],
                         jac=lambda x: torch.as_tensor(A), **kw)
    J = jnlp.canonicalize(jspec, dtype=jnp.float64)
    T = tnlp.canonicalize(tspec, device="cpu")
    x = np.array([[0.25, 0.75]])
    got = T.jac_orig(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got[0], np.asarray(J.jac_orig(x[0])))
    np.testing.assert_array_equal(got[0], A[:, [0, 2]])


def _banded_pair():
    """A parametric chain: c_i = a_i x_i + x_{i+1} (the data sets the
    coupling), f = 0.5 sum w x^2; its J'J + H is tridiagonal."""
    n = 12
    rng = np.random.default_rng(3)
    pdata = {"a": rng.uniform(0.5, 1.5, n - 1), "w": rng.uniform(1, 2, n)}
    common = dict(lcon=np.full(n - 1, -1.0), ucon=np.full(n - 1, 1.0),
                  lvar=np.full(n, -3.0), uvar=np.full(n, 3.0),
                  x0=np.full(n, 0.5), pdata=pdata, name="param_chain")
    jspec = jnlp.NLPSpec(
        f=lambda x, p: 0.5 * jnp.sum(p["w"] * x ** 2) + jnp.sum(x),
        c=lambda x, p: p["a"] * x[:-1] + x[1:], **common)
    tspec = tnlp.NLPSpec(
        f=lambda x, p: 0.5 * torch.sum(p["w"] * x ** 2) + torch.sum(x),
        c=lambda x, p: p["a"] * x[:-1] + x[1:], **common)
    return jspec, tspec, pdata


def test_banded_sample_pdata_pattern_and_solve():
    """BandedKernel(sample_pdata=): the RCM permutation, bandwidth and
    blocking equal the JAX kernel's; the solve on the template data takes
    the JAX kernel's status, outer iterations and x (1e-8)."""
    from onephase_tpu.parallel.banded import BandedKernel as JBanded
    from onephase_tpu.solver import one_phase_solve as jsolve
    from onephase_tpu_torch.parallel.banded import BandedKernel as TBanded
    from onephase_tpu_torch.solver import one_phase_solve as tsolve

    jspec, tspec, pdata = _banded_pair()
    sample = {k: v * 1.1 for k, v in pdata.items()}
    pars = dict(OPTS, **{"kkt.linear_solver_type": "xla"})
    jk = JBanded(jnlp.canonicalize(jspec, dtype=jnp.float64),
                 JParams().with_overrides(pars), sample_pdata=sample)
    tk = TBanded(tnlp.canonicalize(tspec, device="cpu"),
                 TParams().with_overrides(pars), sample_pdata=sample,
                 device="cpu")
    np.testing.assert_array_equal(tk.perm, np.asarray(jk.perm))
    assert (tk.bandwidth, tk.nb, tk.K) == (jk.bandwidth, jk.nb, jk.K)
    rj = jsolve(None, JParams().with_overrides(pars), kernel=jk)
    rt = tsolve(None, TParams().with_overrides(pars), kernel=tk)
    assert rj.status == "Optimal"
    check_solve_parity(rt, rj, x_tol=1e-8, mu_rtol=1e-8)
    with pytest.raises(ValueError, match="matrix_free"):
        TBanded(tnlp.canonicalize(tspec, device="cpu"),
                TParams().with_overrides(pars), matrix_free=True,
                device="cpu")
