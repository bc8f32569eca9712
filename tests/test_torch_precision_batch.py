"""The precision knobs on the batch driver, against the JAX package's
BatchSolver (pallas lane, interpret mode), on make_qp(64, 32) with four
starts: float64 solves at tol 1e-6 with adaptive refinement under
factor_precision "same", "f32" and the fast-f64 lane (the chip_smoke.py
mixed phase's options at a small size), and a float32 solve under
residual_precision="f64", whose between-chunk float64 recheck is skipped
(onephase_tpu/parallel/batch.py:92-95)."""

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
from onephase_tpu_torch.ipm.state import RUNNING
from onephase_tpu_torch.parallel.batch import BatchSolver as TBatch
from test_torch_twins import qp_pair
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MIXED = {"output_level": 0, "term.max_it": 60, "term.tol_opt": 1e-6,
         "chunk_size": 20, "history_capacity": 2,
         "kkt.it_refine_adaptive": True, "kkt.linear_solver_type": "pallas"}
FAST = {"kkt.factor_precision": "f32_fallback", "kkt.fallback_form_f32": True,
        "kkt.hi_matvec_f32pair": "refine", "kkt.it_refine_highprec": True}


def _solvers(opts, dtype):
    jspec, tspec = qp_pair(64, 32)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jops.INTERPRET = True
    try:
        js = JBatch(jnlp.canonicalize(jspec, dtype=jdt),
                    JParams().with_overrides(opts))
    finally:
        jops.INTERPRET = False
    ts = TBatch(tnlp.canonicalize(tspec, dtype=dtype, device="cpu"),
                TParams().with_overrides(opts))
    return js, ts


def _x0s():
    return np.random.default_rng(1).normal(size=(4, 64)) * 0.1


def _solve_jax(js, x0s):
    jops.INTERPRET = True
    try:
        return js.solve(x0s)
    finally:
        jops.INTERPRET = False


@pytest.mark.parametrize("over", [{}, FAST], ids=["same", "fast_f64"])
def test_mixed_batch_matches_jax(over):
    """Both packages certify 4/4 with equal outer iterations and
    factorizations per instance; x to 1e-8 relative to max |x|."""
    js, ts = _solvers(dict(MIXED, **over), torch.float64)
    jst = _solve_jax(js, _x0s())
    tst = ts.solve(_x0s())
    assert js.statuses(jst) == ts.statuses(tst) == ["Optimal"] * 4
    assert tst.t.tolist() == np.asarray(jst.t).tolist()
    assert tst.cum_fac.tolist() == np.asarray(jst.cum_fac).tolist()
    xj = np.asarray(jst.p.x)
    assert np.abs(tst.p.x.numpy() - xj).max() <= 1e-8 * np.abs(xj).max()


def test_f32_factor_batch_matches_jax_until_its_endgame():
    """factor_precision="f32": the first 8 outer iterations equal the JAX
    package's (status, t, cum_fac exactly; x and mu to 1e-8), the operator
    is float32.  Later the float32 factor cannot resolve cond(Q) at tol
    1e-6 (the refinement stops contracting: a-posteriori KKT ratios of
    1e-4 and above in both packages) and the trajectories part by
    rounding, so the rest of the solve is not held here (chip_smoke.py's
    mixed phase runs it to the end at full size)."""
    opts = dict(MIXED, **{"kkt.factor_precision": "f32", "chunk_size": 8})
    js, ts = _solvers(opts, torch.float64)
    jops.INTERPRET = True
    try:
        jst = js.run_chunk(js.init(_x0s()))
    finally:
        jops.INTERPRET = False
    tst = ts.run_chunk(ts.init(_x0s()))
    assert tst.fact.L.dtype == torch.float32
    for k in ("status", "t", "cum_fac"):
        assert getattr(tst, k).tolist() == np.asarray(getattr(jst, k)).tolist()
    xj, muj = np.asarray(jst.p.x), np.asarray(jst.p.mu)
    assert np.abs(tst.p.x.numpy() - xj).max() <= 1e-8 * np.abs(xj).max()
    np.testing.assert_allclose(tst.p.mu.numpy(), muj, rtol=1e-8, atol=0)


def test_residual_f64_batch_skips_recheck_and_matches_jax(monkeypatch):
    """L1: under residual_precision="f64" the batch driver's between-chunk
    float64 recheck does not run (its in-loop test already measures in
    float64), where without the knob it does; the float32 batch then
    matches the JAX package's (statuses, outer iterations and
    factorizations exactly, x to 1e-3 relative: a float32 solve)."""
    opts = dict(MIXED, **{"term.tol_opt": 1e-4, "chunk_size": 5,
                          "kkt.residual_precision": "f64"})
    js, ts = _solvers(opts, torch.float32)
    assert ts.pars.term.batch_f64_recheck
    st = ts.run_chunk(ts.init(_x0s()))
    assert bool((st.status == RUNNING).any())
    calls = []
    monkeypatch.setattr(ts.kernel, "terminate_f64",
                        lambda *a: calls.append(a) or 1 / 0)
    assert ts.recheck_f64(st) is st
    assert not calls
    monkeypatch.undo()
    plain = TBatch(ts.kernel.nlp, TParams().with_overrides(
        dict(opts, **{"kkt.residual_precision": "same"})))
    monkeypatch.setattr(plain.kernel, "terminate_f64",
                        lambda *a: calls.append(a) or
                        torch.zeros_like(st.status))
    plain.recheck_f64(st)
    assert len(calls) == 1
    monkeypatch.undo()
    jst = _solve_jax(js, _x0s())
    tst = ts.solve(_x0s())
    assert ts.statuses(tst) == js.statuses(jst) == ["Optimal"] * 4
    assert tst.t.tolist() == np.asarray(jst.t).tolist()
    assert tst.cum_fac.tolist() == np.asarray(jst.cum_fac).tolist()
    xj = np.asarray(jst.p.x, dtype=np.float64)
    assert np.abs(tst.p.x.double().numpy() - xj).max() \
        <= 1e-3 * np.abs(xj).max()
