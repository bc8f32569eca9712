"""Problem pairs for the port's parity tests: the same problem written for
the JAX package (jnp) and for the port (torch), with data from the same
numpy draws, and the parity checks built on them.  Imported by the other
tests/test_torch_*.py files; it holds no tests of its own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import onephase_tpu.nlp as jnlp
import onephase_tpu_torch.nlp as tnlp
from onephase_tpu.models import zoo as jzoo
from onephase_tpu_torch.models import qp as tqp
from onephase_tpu_torch.models import zoo as tzoo

INF = np.inf

# the zoo problems of the parity suite with the JAX package's figures
# (status, outer iterations; max_it=81, a_norm_penalty=1e-4): on all three
# lanes, except the xla lane's for the problems of LANE_SPLIT
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
    "rosenbrook3": ("Optimal", 46),
    "rosenbrook4": ("Optimal", 50),
    "toy_lp2": ("Optimal", 11),
    "toy_lp3": ("Optimal", 6),
    "toy_lp5": ("Optimal", 8),
    "toy_lp6": ("Optimal", 6),
    "toy_lp7": ("Optimal", 6),
    "toy_lp8": ("Optimal", 7),
    "toy_lp_inf2": ("primal_infeasible", 9),
    "circle2": ("Optimal", 15),
    "circle_nc2": ("Optimal", 14),
    "circle_nc_inf1": ("primal_infeasible", 14),
    "circle_nc_unbd": ("dual_infeasible", 81),
    "starting_point_0.5": ("Optimal", 6),
    "starting_point_-0.5": ("Optimal", 6),
    "bounds_only": ("Optimal", 5),
}
# problems whose trajectory the JAX package's own lanes do not agree on:
# the xla, invchol and pallas lanes end in these outer iterations
# (Rosenbrock's curved valley turns round-off into another step
# sequence).  The port is held to status and argmin and, outer iteration
# by outer iteration, to the JAX package's step from the JAX package's own
# state (check_carried_steps); its iteration count is not held.
LANE_SPLIT = {"rosenbrook3": (46, 41, 47), "rosenbrook4": (50, 53, 49)}
# degenerate LPs (parallel rows) whose last steps amplify round-off: the
# mu trace is held to 1e-6 relative instead of 1e-8; the JAX package's own
# xla and invchol lanes differ by 4.2e-9 (toy_lp5) and 4.4e-8 (toy_lp8)
ZOO_MU_RTOL = {"toy_lp5": 1e-6, "toy_lp8": 1e-6}


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
    """(JAX spec, torch spec) of a zoo problem; "starting_point_<x0>" is
    `starting_point_prob(x0)`, "bounds_only" test_zoo.py's bounds-only
    problem."""
    if name == "hs071":
        return jax_hs071(), tzoo.hs071()
    if name == "bounds_only":
        kw = dict(x0=[0.5, 0.5], lvar=[0.0, 0.0], uvar=[1.0, 1.0])
        return (jnlp.NLPSpec(f=lambda x: (x[0] - 2.0) ** 2
                             + (x[1] + 1.0) ** 2, **kw),
                tnlp.NLPSpec(f=lambda x: (x[0] - 2.0) ** 2
                             + (x[1] + 1.0) ** 2, **kw))
    if name.startswith("starting_point_"):
        start = float(name.rsplit("_", 1)[1])
        return jzoo.starting_point_prob(start), tzoo.starting_point_prob(start)
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


@pytest.fixture
def one_torch_thread():
    """One intra-op torch thread for the test's duration: the port's small
    CPU tensors run an order of magnitude faster than in a thread pool
    competing with the other test workers and JAX's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def jax_solve(jspec, options, lane="xla", dtype=jnp.float64):
    """The JAX package's `one_phase_solve` on `lane` (its Pallas kernels in
    interpret mode on the `pallas` lane, as its own tests run them)."""
    import onephase_tpu
    import onephase_tpu.ops as jops
    jops.INTERPRET = lane == "pallas"
    try:
        return onephase_tpu.one_phase_solve(
            jnlp.canonicalize(jspec, dtype=dtype),
            options=dict(options, **{"kkt.linear_solver_type": lane}))
    finally:
        jops.INTERPRET = False


def port_solve(tspec, options, lane, dtype=torch.float64):
    """The port's `one_phase_solve` on `lane`, on the CPU."""
    import onephase_tpu_torch
    return onephase_tpu_torch.one_phase_solve(
        tnlp.canonicalize(tspec, dtype=dtype, device="cpu"),
        options=dict(options, **{"kkt.linear_solver_type": lane}))


def check_solve_parity(rt, rj, x_tol=1e-6, mu_rtol=1e-8, iterations=True):
    """The port's result `rt` against the JAX package's `rj`: status equal;
    argmin to `x_tol` relative to max(1, |x|); with `iterations`, the outer
    iteration count and the history's t column equal and the
    per-iteration mu trace to `mu_rtol` relative (`mu_rtol=None` holds
    the count but not the trace)."""
    assert rt.status == rj.status, (rt.status, rj.status)
    scale = np.maximum(1.0, np.abs(rj.x))
    np.testing.assert_array_less(np.abs(rt.x - rj.x) / scale, x_tol)
    if not iterations:
        return
    assert rt.iterations == rj.iterations, (rt.iterations, rj.iterations)
    assert [h["t"] for h in rt.history] == [h["t"] for h in rj.history]
    if mu_rtol is None:
        return
    mu_j = np.array([h["mu"] for h in rj.history])
    mu_t = np.array([h["mu"] for h in rt.history])
    np.testing.assert_allclose(mu_t, mu_j, rtol=mu_rtol, atol=0)


def check_carried_steps(name, options, lane="xla", tol=1e-10,
                        max_steps=200, specs=None, ratio_cap=None,
                        kernels=None):
    """Outer iteration by outer iteration along the JAX package's own
    trajectory (chunks of one): the port's outer iteration on `lane` from
    the carried JAX state equals the JAX package's, leaf by leaf to `tol`
    (relative to max(1, max |leaf|)).  The JAX package runs the xla lane
    for the port's xla lane and the invchol lane (the same explicit
    inverse, by XLA) for the port's pallas and invchol lanes (the eigh
    lane for eigh).  Both kernels come from their package's
    `make_kernel` (`options` may name any KKT system).  `specs` gives the
    (JAX, torch) problem pair in place of the zoo's `name`.  With
    `ratio_cap`, the walk ends before the first step whose JAX
    a-posteriori KKT error ratio exceeds it: past that point the direction
    carries round-off of that relative size.  `kernels` gives a
    (JAX, torch) kernel pair built with chunk_size 1 (a structured kernel)
    in place of `make_kernel`'s.  This holds the port's arithmetic where
    round-off makes whole trajectories diverge.  Returns the number of
    steps checked."""
    from onephase_tpu.config import Params as JParams
    from onephase_tpu.ipm.dual import make_kernel as jmake
    from onephase_tpu_torch.config import Params as TParams
    from onephase_tpu_torch.interop import state_from_numpy, state_to_numpy
    from onephase_tpu_torch.ipm.dual import make_kernel as tmake
    import jax

    if kernels is not None:
        jk, tk = kernels
        assert jk.pars.chunk_size == tk.pars.chunk_size == 1
    else:
        jspec, tspec = specs or zoo_pair(name)
        opts = dict(options, chunk_size=1)
        jlane = lane if lane in ("xla", "eigh") else "invchol"
        jk = jmake(jnlp.canonicalize(jspec), JParams().with_overrides(
            dict(opts, **{"kkt.linear_solver_type": jlane})))
        tk = tmake(tnlp.canonicalize(tspec, device="cpu"),
                   TParams().with_overrides(
                       dict(opts, **{"kkt.linear_solver_type": lane})))

    def np_tree(t):
        return jax.tree_util.tree_map(np.asarray, t)

    jst = jk.initial_state()
    compare_states(state_to_numpy(tk.initial_state()), np_tree(jst), tol)
    steps = 0
    while int(jst.status) == 0 and steps < max_steps:
        st = tk.run_chunk(state_from_numpy(np_tree(jst), device="cpu"))
        jst = jk.run_chunk(jst)
        if ratio_cap is not None and float(jst.kkt_ratio) > ratio_cap:
            break
        compare_states(state_to_numpy(st), np_tree(jst), tol,
                       f"step {steps + 1}")
        steps += 1
    return steps


def check_zoo_case(name, lane, jax_results):
    """Solve `name` with the port on `lane` and hold it to the JAX
    package's solve (xla lane; the JAX lanes agree exactly on this zoo but
    for LANE_SPLIT) and to the recorded figures: status and iteration count
    equal, argmin to 1e-6 (relative to max(1, |x|)), the per-iteration mu
    trace to 1e-8 relative (ZOO_MU_RTOL where stated).  A LANE_SPLIT
    problem is held to status, argmin and check_carried_steps."""
    jspec, tspec = zoo_pair(name)
    if name not in jax_results:
        jax_results[name] = jax_solve(jspec, ZOO_OPTS)
    rj = jax_results[name]
    rt = port_solve(tspec, ZOO_OPTS, lane)
    assert (rj.status, rj.iterations) == ZOO_FIGURES[name]
    if name in LANE_SPLIT:
        check_solve_parity(rt, rj, iterations=False)
        # the JAX trajectory the steps follow: xla, or invchol (pallas)
        steps = LANE_SPLIT[name][0 if lane == "xla" else 1]
        assert check_carried_steps(name, ZOO_OPTS, lane) == steps
        return
    assert (rt.status, rt.iterations) == ZOO_FIGURES[name]
    check_solve_parity(rt, rj, mu_rtol=ZOO_MU_RTOL.get(name, 1e-8))


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
