"""The precision knobs of the dense Schur path held to the JAX package:
counterparts of the 10 tests of tests/test_mixed_precision.py run through
both packages, plus `kkt.precond_f32` and `kkt.hi_matvec_f32pair="all"`.
Solves hold status and outer iterations equal and the argmin to the stated
tolerance; the mu trace is not held under a float32 factor (its pivots
differ from the JAX package's by an ulp, which moves the endgame iterates;
test_mixed_precision.py itself holds f32-factored argmins to 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onephase_tpu.nlp as jnlp
import onephase_tpu_torch.nlp as tnlp
from onephase_tpu.config import Params as JParams
from onephase_tpu.ipm.core import OnePhaseKernel as JKernel
from onephase_tpu_torch.config import Params as TParams
from onephase_tpu_torch.interop import state_from_numpy
from onephase_tpu_torch.ipm.core import OnePhaseKernel as TKernel
from test_torch_twins import (assert_close, check_solve_parity, jax_solve,
                              port_solve, zoo_pair)
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BASE = {"term!max_it": 200, "output_level": 0, "term!tol_opt": 1e-6,
        "kkt!it_refine_adaptive": True}
F32 = {"kkt!factor_precision": "f32"}
PROBS = ["rosenbrook2", "toy_lp2", "toy_lp7", "circle1", "circle_nc1",
         "quad_opt"]
LANES = ["pallas", "xla"]
# the float32 factor's argmin tolerance (see the module docstring)
X_TOL_F32 = 1e-5


def _opts(**over):
    return dict(BASE, **over)


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("name", PROBS)
def test_f32_factor_reaches_tol6(name, lane):
    """f64 solve + f32 factor certifies tol 1e-6 within 2 iterations of
    the all-f64 solve (the JAX package's own contract), and with the JAX
    package's status and outer iterations on the same lane."""
    jspec, tspec = zoo_pair(name)
    r64 = port_solve(tspec, _opts(), lane)
    r32 = port_solve(tspec, _opts(**F32), lane)
    assert r64.status == r32.status == "Optimal"
    np.testing.assert_allclose(r32.x, r64.x, rtol=0, atol=1e-5)
    assert abs(r32.iterations - r64.iterations) <= 2
    rj = jax_solve(jspec, _opts(**F32), lane)
    check_solve_parity(r32, rj, x_tol=X_TOL_F32, mu_rtol=None)


@pytest.mark.parametrize("lane", LANES)
def test_f32_factor_direction_parity(lane):
    """The f32-factored, f64-refined direction: float32 factor and
    operator, float64 direction, equal to the port's all-f64 direction to
    1e-8 (relative to 1 + max |dx|) and to the JAX package's f32-factored
    direction from the same state to 1e-10; KKT ratio below 1e-8."""
    jspec, tspec = zoo_pair("rosenbrook2")
    nlp = tnlp.canonicalize(tspec, device="cpu")
    k64 = TKernel(nlp, TParams().with_overrides(
        _opts(**{"kkt.linear_solver_type": lane})))
    k32 = TKernel(nlp, TParams().with_overrides(
        _opts(**F32, **{"kkt.linear_solver_type": lane})))
    assert k32.factor_dtype == torch.float32
    jk = JKernel(jnlp.canonicalize(jspec), JParams().with_overrides(
        _opts(**F32)))
    jst = jk.initial_state()
    st = state_from_numpy(jax.tree_util.tree_map(np.asarray, jst),
                          device="cpu")
    zero = torch.zeros(1, dtype=torch.float64)
    delta = torch.full((1,), 1e-8, dtype=torch.float64)

    def direction(k):
        fact = k.form_factor(st.p, st.cache, k._empty_factor(1))
        (L, D), ok = k.factor(fact.Q, delta, fact=fact)
        assert bool(ok[0])
        M = k.finalize_solver(L)
        fact = fact._replace(L=M, D=D, delta=delta)
        return k.compute_direction(fact, st.p, st.cache, zero, zero,
                                   zero), M

    (d64, _), _ = direction(k64)
    (d32, ratio32), M32 = direction(k32)
    assert M32.dtype == torch.float32 and d32.x.dtype == torch.float64
    scale = 1.0 + float(d64.x.abs().max())
    assert float((d32.x - d64.x).abs().max()) / scale < 1e-8
    assert float(ratio32[0]) < 1e-8
    jf = jk.form_factor(jst.p, jst.cache, jk._empty_factor())
    (jL, jD), jok = jk.factor(jf.Q, jnp.asarray(1e-8))
    jf = jf._replace(L=jk.finalize_solver(jL), D=jD,
                     delta=jnp.asarray(1e-8))
    jd, _ = jk.compute_direction(jf, jst.p, jst.cache, 0.0, 0.0, 0.0)
    for leaf in ("x", "y", "s"):
        assert_close(getattr(d32, leaf)[0], getattr(jd, leaf), 1e-10, leaf)


@pytest.mark.parametrize("lane", LANES)
def test_f32_factor_infeasible_certificate(lane):
    jspec, tspec = zoo_pair("toy_lp_inf1")
    r = port_solve(tspec, _opts(**F32), lane)
    assert r.status == "primal_infeasible"
    check_solve_parity(r, jax_solve(jspec, _opts(**F32), lane),
                       x_tol=X_TOL_F32, mu_rtol=None)


@pytest.mark.parametrize("lane", ["xla"])
def test_f32_fallback_unbounded_certificate(lane):
    """lp_unbd: without the ray certificate the pure f32 factor cannot
    certify (MAX_IT, as in the JAX package), f32_fallback and all-f64 do
    (dual_infeasible in 17 iterations in both packages, argmin to 1e-6
    relative); with the ray the pure f32 factor certifies.  That last
    count is held to the JAX package's lanes, which differ: 46 (xla), 45
    (pallas).  The xla lane only: the pure-f32 runs take 200 outer
    iterations (the pallas lane's fallback is held by
    test_fallback_form_f32_reforms_in_f64)."""
    jspec, tspec = zoo_pair("lp_unbd")
    no_ray = {"term!unbounded_ray_patience": 0}
    pure = port_solve(tspec, _opts(**F32, **no_ray), lane)
    assert pure.status != "dual_infeasible"
    jpure = jax_solve(jspec, _opts(**F32, **no_ray), lane)
    assert (pure.status, pure.iterations) == (jpure.status, jpure.iterations)
    for over in ({"kkt!factor_precision": "f32_fallback"}, {}):
        r = port_solve(tspec, _opts(**over, **no_ray), lane)
        assert r.status == "dual_infeasible"
        check_solve_parity(r, jax_solve(jspec, _opts(**over, **no_ray),
                                        lane), mu_rtol=None)
    ray = port_solve(tspec, _opts(**F32), lane)
    assert ray.status == "dual_infeasible"
    assert ray.iterations in (45, 46)


def test_residual_precision_f64_runs_and_is_honest():
    """f32 solve with f64-measured residuals: the JAX package's status and
    iterations, argmin to 1e-4 and the mu trace to 1e-4 relative (a
    float32 solve); the measured violation agrees with an independent f64
    evaluation, and the final iterate passes terminate_f64."""
    jspec, tspec = zoo_pair("toy_lp2")
    opts = _opts(**{"kkt!residual_precision": "f64", "term!tol_opt": 1e-4})
    for lane in LANES:
        r = port_solve(tspec, opts, lane, dtype=torch.float32)
        assert r.status == "Optimal"
        rj = jax_solve(jspec, opts, lane, dtype=jnp.float32)
        check_solve_parity(r, rj, x_tol=1e-4, mu_rtol=1e-4)
        nlp = r.kernel.nlp
        a64 = nlp.a_of_hi(torch.as_tensor(r.x[None, :nlp.n],
                                          dtype=torch.float32))
        vio64 = max(0.0, float(-a64.min()))
        assert abs(vio64 - float(r.max_violation)) < 1e-6
        st = r.state
        assert int(r.kernel.terminate_f64(st.p, st.cache, st.bvals)[0]) == 1


def test_grad_lag_hi_matches_f64_oracle():
    """nlp.grad_lag_hi of a float32 problem equals the float64 oracles'
    g - J^T y and the JAX package's grad_lag_hi to 1e-12."""
    jspec, tspec = zoo_pair("circle_nc1")
    nlp32 = tnlp.canonicalize(tspec, dtype=torch.float32, device="cpu")
    nlp64 = tnlp.canonicalize(tspec, dtype=torch.float64, device="cpu")
    jnlp32 = jnlp.canonicalize(jspec, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    x = rng.normal(size=nlp32.n).astype(np.float32)
    y = rng.uniform(0.1, 2.0, size=nlp32.m).astype(np.float32)
    xt, yt = torch.tensor(x[None]), torch.tensor(y[None])
    hi = nlp32.grad_lag_hi(xt, yt, torch.zeros(1, dtype=torch.float64))
    ref = nlp64.grad_f(xt.double()) - nlp64.jtprod(xt.double(), yt.double())
    assert float((hi - ref).abs().max()) < 1e-12
    jhi = np.asarray(jnlp32.grad_lag_hi(jnp.asarray(x), jnp.asarray(y),
                                        jnp.asarray(0.0, jnp.float64)))
    assert np.abs(hi[0].numpy() - jhi).max() < 1e-12


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("name", ["toy_lp2", "rosenbrook2", "circle_nc1"])
def test_bf16_q_formation(name, lane):
    """q_form_dtype="bf16" under the f32 factor: the trajectory of the f32
    factor alone (status, iterations, argmin to 1e-5) in the port, and the
    JAX package's status and iterations."""
    jspec, tspec = zoo_pair(name)
    bf = _opts(**F32, **{"kkt!q_form_dtype": "bf16"})
    r0 = port_solve(tspec, _opts(**F32), lane)
    r1 = port_solve(tspec, bf, lane)
    assert r0.status == r1.status == "Optimal"
    assert r0.iterations == r1.iterations
    np.testing.assert_allclose(r1.x, r0.x, rtol=0, atol=1e-5)
    check_solve_parity(r1, jax_solve(jspec, bf, lane), x_tol=X_TOL_F32,
                       mu_rtol=None)


def test_bf16_q_matches_dense_and_skips_the_kernel(monkeypatch):
    """xla_fused_q(mxu_dtype=bf16) agrees with the f32 dense expression to
    bf16 resolution (3e-2 of max |Q|, the JAX test's bound) and with the
    JAX package's bf16 scale-split to 1e-6 of max |Q| (products of bf16
    values are exact in f32; only the summation order differs); on the
    pallas lane the dispatch never reaches the Q kernel under bf16."""
    from onephase_tpu.ops.schur import xla_fused_q as jfq
    from onephase_tpu_torch.ops import schur
    rng = np.random.default_rng(3)
    m, n = 96, 64
    Jc = rng.normal(size=(m, n)).astype(np.float32)
    w = rng.uniform(1e-4, 1e4, size=m).astype(np.float32)
    H = (lambda A: A @ A.T)(rng.normal(size=(n, n))).astype(np.float32)
    bnd = rng.uniform(0, 1, size=n).astype(np.float32)
    args = (torch.tensor(Jc), torch.tensor(w[None]), torch.tensor(H),
            torch.tensor(bnd[None]))
    q32 = schur.xla_fused_q(*args)[0].numpy()
    qbf = schur.xla_fused_q(*args, mxu_dtype=torch.bfloat16)[0].numpy()
    jbf = np.asarray(jfq(jnp.asarray(Jc), jnp.asarray(w), jnp.asarray(H),
                         jnp.asarray(bnd), mxu_dtype=jnp.bfloat16))
    scale = np.abs(q32).max()
    assert np.abs(qbf - q32).max() / scale < 3e-2
    assert np.abs(qbf - jbf).max() / scale < 1e-6

    def no_kernel(*a, **k):
        raise AssertionError("the Q kernel was reached under bf16")

    monkeypatch.setattr(schur, "pallas_fused_q", no_kernel)
    got = schur.fused_q(*args, True, torch.bfloat16)
    assert torch.equal(got[0], torch.tensor(qbf))
    with pytest.raises(AssertionError):
        schur.fused_q(*args, True)


def test_pair_matvec_accuracy():
    """ops/refine's f32-pair products reproduce f64 matvecs to 1e-12
    relative with wide dynamic range, shared and batched operands, and
    agree with the JAX package's to 1e-12."""
    from onephase_tpu.ops import refine as jr
    from onephase_tpu_torch.ops import refine as r
    rng = np.random.default_rng(0)
    A = (rng.normal(size=(800, 120))
         * np.exp(rng.normal(size=(800, 120)) * 3.0))
    x = rng.normal(size=(2, 120)) * np.exp(rng.normal(size=(2, 120)) * 3)
    w = rng.normal(size=(2, 800))
    At, xt, wt = torch.tensor(A), torch.tensor(x), torch.tensor(w)
    ref1, ref2 = x @ A.T, w @ A
    for Aop in (At, At.expand(2, 800, 120).contiguous()):
        e1 = np.abs(r.pair_matvec64(Aop, xt).numpy() - ref1).max()
        e2 = np.abs(r.pair_matvec64_t(Aop, wt).numpy() - ref2).max()
        assert e1 / np.abs(ref1).max() < 1e-12
        assert e2 / np.abs(ref2).max() < 1e-12
    j1 = np.asarray(jr.pair_matvec64(jnp.asarray(A), jnp.asarray(x[0])))
    j2 = np.asarray(jr.pair_matvec64_t(jnp.asarray(A), jnp.asarray(w[0])))
    assert np.abs(r.pair_matvec64(At, xt)[0].numpy() - j1).max() \
        / np.abs(j1).max() < 1e-12
    assert np.abs(r.pair_matvec64_t(At, wt)[0].numpy() - j2).max() \
        / np.abs(j2).max() < 1e-12


FAST = {"kkt!factor_precision": "f32_fallback",
        "kkt!fallback_form_f32": True,
        "kkt!hi_matvec_f32pair": "refine",
        "kkt!it_refine_highprec": True,
        "kkt!it_refine_tol": 1e-12}


@pytest.mark.parametrize("lane", ["invchol", "pallas"])
@pytest.mark.parametrize("name", ["toy_lp1", "rosenbrook2", "circle_nc1",
                                  "toy_lp_inf1"])
def test_fast_f64_lane_parity(name, lane):
    """The fast-f64 lane (f32 Q formation with the float64 re-form on
    fallback, f32-pair refinement products) keeps the plain f64 solve's
    status and argmin (atol 2e-5, the JAX test's), and has the JAX
    package's status, iterations and argmin (1e-6) on the same lane."""
    jspec, tspec = zoo_pair(name)
    ref = port_solve(tspec, _opts(), lane)
    r = port_solve(tspec, _opts(**FAST), lane)
    assert r.status == ref.status
    if ref.status == "Optimal":
        np.testing.assert_allclose(r.x, ref.x, rtol=0, atol=2e-5)
    check_solve_parity(r, jax_solve(jspec, _opts(**FAST), lane),
                       mu_rtol=None)


@pytest.mark.parametrize("lane", ["invchol", "pallas"])
def test_fallback_form_f32_reforms_in_f64(lane, monkeypatch):
    """lp_unbd without the ray: the race to ||x|| = 1/tol_unbounded makes
    the strict f32 screen reject, so the f64 Q is re-formed and factored
    (counted here), and the solve certifies as the JAX package's does
    (status, iterations, argmin to 1e-6)."""
    jspec, tspec = zoo_pair("lp_unbd")
    opts = _opts(**FAST, **{"term!unbounded_ray_patience": 0})
    calls = []
    orig = tnlp.CanonNLP.jtdj_fused

    def counted(self, Jc, d, H, use_pallas=False, mxu_dtype=None):
        calls.append(d.dtype)
        return orig(self, Jc, d, H, use_pallas, mxu_dtype)

    monkeypatch.setattr(tnlp.CanonNLP, "jtdj_fused", counted)
    r = port_solve(tspec, opts, lane)
    assert r.status == "dual_infeasible"
    assert torch.float64 in calls and torch.float32 in calls
    check_solve_parity(r, jax_solve(jspec, opts, lane), mu_rtol=None)


@pytest.mark.parametrize("lane", ["invchol", "pallas"])
@pytest.mark.parametrize("name", ["toy_lp1", "circle_nc1", "rosenbrook2"])
def test_precond_f32_parity(name, lane):
    """kkt.precond_f32: the solve operator M carried in float32 on an f64
    solve; the JAX package's status, iterations and argmin (1e-6)."""
    jspec, tspec = zoo_pair(name)
    opts = _opts(**{"kkt!precond_f32": True})
    r = port_solve(tspec, opts, lane)
    assert r.state.fact.L.dtype == torch.float32
    assert r.state.p.x.dtype == torch.float64
    check_solve_parity(r, jax_solve(jspec, opts, lane), mu_rtol=None)


@pytest.mark.parametrize("name", ["rosenbrook2", "circle_nc1"])
def test_hi_matvec_all_parity(name):
    """kkt.hi_matvec_f32pair="all": the direction's J products as f32
    pairs too; the JAX package's status, iterations and argmin (1e-6)."""
    jspec, tspec = zoo_pair(name)
    opts = _opts(**{"kkt!hi_matvec_f32pair": "all",
                    "kkt!it_refine_highprec": True})
    r = port_solve(tspec, opts, "xla")
    assert r.kernel._hi_pair_dir
    check_solve_parity(r, jax_solve(jspec, opts, "xla"), mu_rtol=None)


@pytest.mark.parametrize("over", [F32, {"kkt!precond_f32": True}],
                         ids=["f32", "precond_f32"])
def test_carried_mixed_state_steps_like_jax(over):
    """A JAX state of an f64 solve with a float32 operator carried across
    (state_from_numpy keeps its float32 leaves): two outer iterations of
    the port from it equal the JAX package's (status, t, cum_fac exactly;
    x and mu to 1e-8), and the carried operator stays float32."""
    from onephase_tpu_torch.interop import state_to_numpy
    jspec, tspec = zoo_pair("circle1")
    opts = _opts(**over, **{"kkt.linear_solver_type": "invchol",
                            "chunk_size": 2})
    jk = JKernel(jnlp.canonicalize(jspec), JParams().with_overrides(opts))
    tk = TKernel(tnlp.canonicalize(tspec, device="cpu"),
                 TParams().with_overrides(opts))
    jst = jax.tree_util.tree_map(np.asarray, jk.initial_state())
    assert jst.fact.L.dtype == np.float32
    st = state_from_numpy(jst, device="cpu")
    assert st.fact.L.dtype == torch.float32
    assert st.p.x.dtype == torch.float64
    st = tk.run_chunk(st)
    jout = jax.tree_util.tree_map(np.asarray, jk.run_chunk(jk.initial_state()))
    out = state_to_numpy(st)
    assert out.fact.L.dtype == np.float32
    for k in ("status", "t", "cum_fac"):
        assert int(getattr(out, k)[0]) == int(getattr(jout, k)), k
    assert_close(out.p.x[0], jout.p.x, 1e-8, "x")
    assert_close(out.p.mu[0], jout.p.mu, 1e-8, "mu")
