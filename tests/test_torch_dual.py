"""The Schur-dual (Woodbury) LP path through both packages, float64:
tests/test_dual.py's cases, the dual path's step from the JAX package's
own state, the LP models, `woodbury_solve` and the inverse-iteration
eigenvalue, and a small batch against the JAX BatchSolver.

The dual path's endgame is decided by round-off: the Woodbury form
cancels D^-1 - D^-1 Jc^T S^-1 Jc D^-1 where D^-1 is huge, and the JAX
package's own a-posteriori KKT error ratio reaches 1e-7..4e-2 there, so
its own drivers end the same LP in different outer iterations at
different points (ROADMAP R5).  Each tests/test_dual.py case is held to
status, to the objective and argmin of the primal solve within the
envelope the JAX package's own dual runs reach (DUAL_ENVELOPE), and step
by step to the JAX package's step from its own state up to the first step
whose direction it measures as worse than 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onephase_tpu
import onephase_tpu.nlp as jnlp
import onephase_tpu_torch
import onephase_tpu_torch.nlp as tnlp
from onephase_tpu.config import Params as JParams
from onephase_tpu.models.lp import LPData as JLPData
from onephase_tpu_torch.config import Params as TParams
from onephase_tpu_torch.models.lp import LPData as TLPData
from test_torch_twins import assert_close, check_carried_steps
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DUAL = {"output_level": 0, "kkt.kkt_solver_type": "schur_dual"}
# The JAX package's dual solves of _lp(seed) for seeds 0, 1, 2 take 11, 21
# and 21 outer iterations by one_phase_solve, 37, 16 and 14 by its
# BatchSolver at B = 1, and 12, 25 and 13 in the third lane of B = 3 (the
# same LP from the same start).  Over those runs their objective stays
# within 2.9e-7 relative and their argmin within 9.9e-5 of the primal
# solve's; the port's dual solves are held to that envelope.
DUAL_ENVELOPE = {"obj_rel": 2.9e-7, "x_abs": 9.9e-5}
# steps check_carried_steps holds to 1e-10 up to its ratio cap
DUAL_CARRIED = {0: 9, 1: 7, 2: 8}


def _lp(cls, seed=0, m=24, n=48, **kw):
    """tests/test_dual.py:19-29's LP in the data form of `cls`."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)) * (rng.random((m, n)) < 0.3)
    A[np.all(A == 0.0, axis=1), 0] = 1.0
    x_feas = rng.random(n)
    b = A @ x_feas
    return cls(cvec=rng.normal(size=n), A=A, lcon=b - 1.0, ucon=b + 1.0,
               lvar=np.full(n, -5.0), uvar=np.full(n, 5.0),
               name=f"lp{seed}", **kw)


def _pair(seed, **kw):
    return (_lp(JLPData, seed, **kw).to_spec(),
            _lp(TLPData, seed, **kw).to_spec(device="cpu"))


def _port_solve(tspec, options):
    return onephase_tpu_torch.one_phase_solve(
        tnlp.canonicalize(tspec, device="cpu"), options=options)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dual_matches_primal_and_jax(seed):
    """tests/test_dual.py:32-40 on the port.  The primal (schur) solve
    equals the JAX package's: status, outer iterations, objective to 1e-12
    and argmin to 1e-10.  The dual solve certifies Optimal, as the JAX
    package's does there, within DUAL_ENVELOPE of the primal solve; its
    steps are held by test_dual_carried_steps."""
    jspec, tspec = _pair(seed)
    rp = onephase_tpu.one_phase_solve(jspec, options={"output_level": 0})
    tp = _port_solve(tspec, {"output_level": 0})
    assert (tp.status, tp.iterations) == (rp.status, rp.iterations)
    assert tp.obj == pytest.approx(rp.obj, rel=1e-12)
    np.testing.assert_allclose(tp.x, rp.x, rtol=0, atol=1e-10)
    td = _port_solve(tspec, DUAL)
    assert rp.status == td.status == "Optimal"
    assert abs(td.obj - rp.obj) <= DUAL_ENVELOPE["obj_rel"] * abs(rp.obj)
    np.testing.assert_allclose(td.x, rp.x, rtol=0,
                               atol=DUAL_ENVELOPE["x_abs"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dual_carried_steps(seed):
    """The dual path's outer iteration from the JAX package's own state
    (factor tuples, placeholders and all, through interop) equals the JAX
    package's to 1e-10, up to the first step whose direction the JAX
    package measures as worse than 1e-10."""
    steps = check_carried_steps(None, DUAL, specs=_pair(seed),
                                ratio_cap=1e-10)
    assert steps == DUAL_CARRIED[seed], steps


def test_dual_solve_operator_algebra():
    """tests/test_dual.py:43-69 on the port: chol_solve applies
    (diag(bnd + delta) + Jc^T diag(wc) Jc)^-1 to 1e-8 (a dense solve), the
    factor verdict, S's factor and the operator's result equal the JAX
    package's to 1e-10, on a batch of two weight vectors."""
    from onephase_tpu.ipm.dual import SchurDualKernel as JDual
    from onephase_tpu_torch.ipm.dual import SchurDualKernel as TDual
    jspec, tspec = _pair(1, m=10, n=20)
    pars = {"output_level": 0, "kkt.kkt_solver_type": "schur_dual"}
    jk = JDual(jnlp.canonicalize(jspec), JParams().with_overrides(pars))
    tk = TDual(tnlp.canonicalize(tspec, device="cpu"),
               TParams().with_overrides(pars))
    rng = np.random.default_rng(2)
    dvec = np.abs(rng.normal(size=(2, tk.m))) + 0.1
    b = rng.normal(size=(2, tk.n))
    delta = 1e-3
    Jc = tk._Jc_const
    wc, bnd = tk.nlp.split_canonical_sq(torch.as_tensor(dvec))
    (L, D), ok = tk.factor((wc, bnd, None),
                           torch.full((2,), delta, dtype=torch.float64))
    assert ok.all() and L[2] is None
    x = tk.chol_solve(tk.finalize_solver(L), torch.as_tensor(b))
    for i in range(2):
        jwc, jbnd = jk.nlp.split_canonical_sq(jnp.asarray(dvec[i]))
        (jL, _), jok = jk.factor((jwc, jbnd, jk._Jc_const), delta)
        assert bool(jok)
        assert_close(L[0][i], np.asarray(jL[0]), 1e-10, "S factor")
        jx = jk.chol_solve(jk.finalize_solver(jL), jnp.asarray(b[i]))
        assert_close(x[i], np.asarray(jx), 1e-10, "x")
        Q = (Jc.T * wc[i]) @ Jc + torch.diag(bnd[i] + delta)
        np.testing.assert_allclose((Q @ x[i]).numpy(), b[i], rtol=1e-8,
                                   atol=1e-8)


def test_dual_gating():
    """tests/test_dual.py:72-87 and the other gates of the JAX package's
    SchurDualKernel: a Hessian, factor_precision="f32_fallback", no
    original rows, or another kkt_solver_type raise its ValueErrors."""
    from onephase_tpu_torch.ipm.dual import SchurDualKernel
    from onephase_tpu_torch.models.lp import lp_spec
    spec = tnlp.NLPSpec(
        f=lambda x: torch.sum(x ** 2), c=lambda x: x[:1],
        lcon=np.array([-1.0]), ucon=np.array([1.0]),
        lvar=np.full(2, -2.0), uvar=np.full(2, 2.0), x0=np.zeros(2))
    bounds_only = lp_spec([1.0, 1.0], np.zeros((0, 2)), [], [],
                          [0.0, 0.0], [1.0, 1.0], device="cpu")
    lp = _lp(TLPData, 0).to_spec(device="cpu")
    for sp, over in ((spec, {}), (bounds_only, {}),
                     (lp, {"kkt.factor_precision": "f32_fallback"}),
                     (lp, {"kkt.kkt_solver_type": "schur"})):
        with pytest.raises(ValueError):
            SchurDualKernel(tnlp.canonicalize(sp, device="cpu"),
                            TParams().with_overrides(dict(DUAL, **over)))


def test_lp_models_match_jax():
    """LPData/lp_spec and perturb_infeasible against the JAX package's: the
    same bounds and rows, f and c equal at random points (float32 and
    float64 data), and the perturbed LP certifies primal_infeasible on the
    dual path as in the JAX package."""
    from onephase_tpu.models.lp import perturb_infeasible as jperturb
    from onephase_tpu_torch.models.lp import perturb_infeasible as tperturb
    jspec, tspec = _pair(0)
    jn, tn = jnlp.canonicalize(jspec), tnlp.canonicalize(tspec, device="cpu")
    assert (tn.n, tn.m, tn.m_orig) == (jn.n, jn.m, jn.m_orig)
    for a in ("lcon", "ucon", "lvar", "uvar", "x0"):
        np.testing.assert_array_equal(getattr(tspec, a), getattr(jspec, a))
    assert tspec.zero_hess and tspec.constant_jac and tspec.lin == jspec.lin
    x = np.random.default_rng(3).normal(size=(2, tn.n))
    for dt in (torch.float64, torch.float32):
        xt = torch.as_tensor(x, dtype=dt)
        tol = 1e-12 if dt == torch.float64 else 1e-5
        for i in range(2):
            assert_close(tn.f(xt)[i], np.asarray(jn.f(jnp.asarray(x[i]))),
                         tol, "f")
            assert_close(tn.c(xt)[i], np.asarray(jn.c(jnp.asarray(x[i]))),
                         tol, "c")
    jp, tp = jperturb(jspec, 3.0), tperturb(tspec, 3.0)
    assert tp.name == jp.name
    np.testing.assert_array_equal(tp.lcon, jp.lcon)
    np.testing.assert_array_equal(tp.ucon, jp.ucon)
    rj = onephase_tpu.one_phase_solve(jp, options=DUAL)
    rt = _port_solve(tp, DUAL)
    assert rt.status == rj.status


def test_woodbury_and_min_eig_match_jax():
    """woodbury_solve (with and without refinement) equals the JAX
    package's to 1e-10 and solves (A + U C V) x = b; the inverse-iteration
    eigenvalue estimate equals the JAX package's and the smallest
    eigenvalue to 1e-10 (start vectors differ: a torch.Generator against
    PRNGKey(0))."""
    from onephase_tpu.ops import woodbury as jw
    from onephase_tpu_torch.ops import woodbury as tw
    rng = np.random.default_rng(5)
    n, k = 12, 3
    Qo, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = (Qo * np.linspace(0.5, 12.0, n)) @ Qo.T    # eigenvalue gap 4x
    U, V = rng.normal(size=(n, k)), rng.normal(size=(k, n))
    C = np.diag(rng.random(k) + 0.5)
    b = rng.normal(size=n)
    At = torch.as_tensor(A)
    Ainv = torch.linalg.inv(At)
    jAinv = jnp.linalg.inv(jnp.asarray(A))
    for refine in (0, 2):
        x = tw.woodbury_solve(lambda v: Ainv @ v, torch.as_tensor(U),
                              torch.as_tensor(C), torch.as_tensor(V),
                              torch.as_tensor(b), refine=refine,
                              matvec_A=(lambda v: At @ v) if refine else None)
        jx = jw.woodbury_solve(lambda v: jAinv @ v, jnp.asarray(U),
                               jnp.asarray(C), jnp.asarray(V), jnp.asarray(b),
                               refine=refine, matvec_A=(
                                   lambda v: jnp.asarray(A) @ v)
                               if refine else None)
        assert_close(x, np.asarray(jx), 1e-10, "woodbury")
        np.testing.assert_allclose((A + U @ C @ V) @ x.numpy(), b,
                                   atol=1e-10)
    lam_min = np.linalg.eigvalsh(A)[0]
    gen = torch.Generator().manual_seed(7)
    lam, v = tw.min_eig_inverse_iteration(lambda v: At @ v,
                                          lambda v: Ainv @ v, n,
                                          generator=gen)
    jlam, _ = jw.min_eig_inverse_iteration(lambda v: jnp.asarray(A) @ v,
                                           lambda v: jAinv @ v, n)
    assert abs(float(lam) - float(jlam)) <= 1e-10 * lam_min
    assert abs(float(lam) - lam_min) <= 1e-10 * lam_min
    assert abs(float(torch.linalg.vector_norm(v)) - 1.0) < 1e-12


def test_dual_batch_matches_jax():
    """Two starts of tests/test_dual.py's LP (seed 0) through both
    packages' BatchSolver on the dual path at the bench's tolerance
    (1e-4), where the endgame round-off does not yet decide the steps:
    statuses, outer iterations and factorizations equal, x to 1e-8."""
    from onephase_tpu.parallel.batch import BatchSolver as JBatch
    from onephase_tpu_torch.parallel.batch import BatchSolver as TBatch
    opts = dict(DUAL, **{"term.tol_opt": 1e-4, "chunk_size": 20})
    jspec, tspec = _pair(0)
    x0s = np.random.default_rng(1).uniform(-1.0, 1.0, size=(2, 48))
    js = JBatch(jnlp.canonicalize(jspec), JParams().with_overrides(opts))
    jst = js.solve(x0s)
    ts = TBatch(tnlp.canonicalize(tspec, device="cpu"),
                TParams().with_overrides(opts))
    tst = ts.solve(x0s)
    assert ts.statuses(tst) == js.statuses(jst) == ["Optimal"] * 2
    for k in ("t", "cum_fac"):
        np.testing.assert_array_equal(getattr(tst, k).numpy(),
                                      np.asarray(getattr(jst, k)))
    np.testing.assert_allclose(tst.p.x.numpy(), np.asarray(jst.p.x),
                               rtol=0, atol=1e-8)
