"""Problem pairs for the port's parity tests: the same problem written for
the JAX package (jnp) and for the port (torch), with data from the same
numpy draws, and the parity checks built on them.  Imported by the other
tests/test_torch_*.py files; it holds no tests of its own."""

import jax.numpy as jnp
import numpy as np
import torch

import bench
import onephase_tpu.nlp as jnlp
import onephase_tpu_torch.nlp as tnlp
from onephase_tpu.models import zoo as jzoo
from onephase_tpu_torch.models import qp as tqp
from onephase_tpu_torch.models import zoo as tzoo

INF = np.inf

# the zoo problems of the parity suite with the JAX package's figures on
# all three lanes (status, outer iterations; max_it=81, a_norm_penalty=1e-4)
ZOO_FIGURES = {
    "rosenbrook2": ("Optimal", 36),
    "toy_lp0": ("Optimal", 3),
    "toy_lp1": ("Optimal", 7),
    "toy_lp_inf1": ("primal_infeasible", 6),
    "circle1": ("Optimal", 8),
    "circle_nc1": ("Optimal", 6),
    "quad_opt": ("Optimal", 1),
    "lp_unbd": ("dual_infeasible", 17),
    "quad_unbd": ("MAX_IT", 81),
    "unbd_feas": ("Optimal", 15),
    "hs071": ("Optimal", 13),
}


def jax_hs071():
    return jnlp.NLPSpec(
        f=lambda x: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2],
        c=lambda x: jnp.stack([x[0] * x[1] * x[2] * x[3],
                               x[0] ** 2 + x[1] ** 2 + x[2] ** 2
                               + x[3] ** 2]),
        lcon=[25.0, 40.0], ucon=[INF, 40.0],
        lvar=[1.0] * 4, uvar=[5.0] * 4, x0=[1.0, 5.0, 5.0, 1.0],
        name="hs071")


def zoo_pair(name):
    """(JAX spec, torch spec) of a zoo problem."""
    if name == "hs071":
        return jax_hs071(), tzoo.hs071()
    return getattr(jzoo, name)(), getattr(tzoo, name)()


def fixed_var_pair():
    """A problem with a fixed variable (x1 = 2.5) and a range row."""
    kw = dict(lcon=[1.0, -1.0], ucon=[INF, 3.0],
              lvar=[-1.0, 2.5, -1.0], uvar=[1.0, 2.5, 1.0],
              x0=[0.0, 2.5, 0.0], name="fixed_var")
    j = jnlp.NLPSpec(
        f=lambda x: x[0] ** 2 + x[1] * x[2] + jnp.exp(x[2]),
        c=lambda x: jnp.stack([x[0] + x[1] + x[2], x[0] * x[2] - x[1]]), **kw)
    t = tnlp.NLPSpec(
        f=lambda x: x[0] ** 2 + x[1] * x[2] + torch.exp(x[2]),
        c=lambda x: torch.stack([x[0] + x[1] + x[2], x[0] * x[2] - x[1]]),
        **kw)
    return j, t


def qp_pair(n, m, seed=0):
    return bench.make_qp(n, m, seed), tqp.make_qp(n, m, seed, device="cpu")


ZOO_OPTS = {"term!max_it": 81, "a_norm_penalty": 1e-4, "output_level": 0}


def assert_close(got, want, tol, path=""):
    """Equal shapes, equal finiteness, and the finite entries within
    tol * max(1, max |want|) (integers and booleans exactly)."""
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=path)
        return
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=path)
    if finite.any():
        scale = max(1.0, float(np.abs(want[finite]).max()))
        np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                                   atol=tol * scale, err_msg=path)


def compare_states(port, jx, tol, path="state"):
    """Leaf-by-leaf: the port's batch-first numpy tree vs an unbatched JAX
    numpy tree (placeholders carried as None in the port are skipped;
    plain tuples, a structured kernel's block factors, element by
    element)."""
    if port is None:
        return
    if isinstance(port, dict):
        for k in port:
            compare_states(port[k], jx[k], tol, f"{path}.{k}")
        return
    if isinstance(port, tuple):
        names = getattr(port, "_fields", range(len(port)))
        for i, name in enumerate(names):
            compare_states(port[i], jx[i], tol, f"{path}.{name}")
        return
    assert_close(port[0], jx, tol, path)


def check_zoo_case(name, lane, jax_results):
    """Solve `name` with the port on `lane` and hold it to the JAX
    package's solve (xla lane; the JAX lanes agree exactly on this zoo) and
    to the recorded figures: status and iteration count equal, argmin to
    1e-6 (relative to max(1, |x|)), the per-iteration mu trace to 1e-8
    relative."""
    import onephase_tpu
    import onephase_tpu_torch
    jspec, tspec = zoo_pair(name)
    if name not in jax_results:
        jax_results[name] = onephase_tpu.one_phase_solve(
            jspec, options=ZOO_OPTS)
    rj = jax_results[name]
    rt = onephase_tpu_torch.one_phase_solve(
        tnlp.canonicalize(tspec, device="cpu"),
        options=dict(ZOO_OPTS, **{"kkt.linear_solver_type": lane}))
    assert (rj.status, rj.iterations) == ZOO_FIGURES[name]
    assert (rt.status, rt.iterations) == ZOO_FIGURES[name]
    scale = np.maximum(1.0, np.abs(rj.x))
    np.testing.assert_array_less(np.abs(rt.x - rj.x) / scale, 1e-6)
    mu_j = np.array([h["mu"] for h in rj.history])
    mu_t = np.array([h["mu"] for h in rt.history])
    assert mu_t.shape == mu_j.shape
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-8, atol=0)
    assert [h["t"] for h in rt.history] == [h["t"] for h in rj.history]


# bench.py:126-140 options with the between-chunk float64 recheck off, so
# the in-loop measurement alone decides
BENCH_OPTS = {"output_level": 0, "term.max_it": 60, "term.tol_opt": 1e-4,
              "chunk_size": 20, "history_capacity": 2,
              "kkt.it_refine_highprec": True,
              "kkt.linear_solver_type": "pallas",
              "term.batch_f64_recheck": False}


def check_batch_case(dtype):
    """make_qp(64, 32), batch 4, x0 from default_rng(1) * 0.1: both
    packages certify 4/4 Optimal in 8 outer iterations with 9
    factorizations each; x agrees to 1e-8 (f64) or 1e-3 relative (f32);
    each batched instance equals the port's single solve of it."""
    import onephase_tpu.ops as jops
    from onephase_tpu.config import Params as JParams
    from onephase_tpu.parallel.batch import BatchSolver as JBatch
    from onephase_tpu_torch.config import Params as TParams
    from onephase_tpu_torch.parallel.batch import BatchSolver as TBatch

    jspec, tspec = qp_pair(64, 32)
    x0s = np.random.default_rng(1).normal(size=(4, 64)) * 0.1
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jops.INTERPRET = True
    try:
        js = JBatch(jnlp.canonicalize(jspec, dtype=jdt),
                    JParams().with_overrides(BENCH_OPTS))
        jst = js.solve(x0s)
    finally:
        jops.INTERPRET = False
    ts = TBatch(tnlp.canonicalize(tspec, dtype=dtype, device="cpu"),
                TParams().with_overrides(BENCH_OPTS))
    tst = ts.solve(x0s)
    assert js.statuses(jst) == ["Optimal"] * 4
    assert ts.statuses(tst) == ["Optimal"] * 4
    for st in (jst, tst):
        assert np.asarray(st.t).tolist() == [9] * 4      # 8 outer iterations
        assert np.asarray(st.cum_fac).tolist() == [9] * 4
    xj = np.asarray(jst.p.x, dtype=np.float64)
    xt = tst.p.x.double().numpy()
    if dtype == torch.float64:
        np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-8)
    else:
        assert np.abs(xt - xj).max() <= 1e-3 * np.abs(xj).max()
    single_tol = 1e-12 if dtype == torch.float64 else 1e-5
    for i in range(4):
        s1 = ts.solve(x0s[i:i + 1])
        for k in ("status", "t", "cum_fac"):
            assert int(getattr(s1, k)[0]) == int(getattr(tst, k)[i]), k
        x1 = s1.p.x[0].double().numpy()
        assert np.abs(x1 - xt[i]).max() <= single_tol * np.abs(xt[i]).max()
