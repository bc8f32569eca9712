"""The symmetric and clever-symmetric KKT paths and the eigh backend
through both packages, float64: the LDL^T kernel (tests/
test_symmetric_kkt.py's matrices, batched), the direction agreement of
schur, symmetric and clever_symmetric, the end-to-end cases of
test_symmetric_kkt.py, the `symmetric`/`clever` configurations of
test_trace_invariants.py, the clever-rescale and eigh cases of
test_parity_modes.py, and a small batch against the JAX BatchSolver.

The unpivoted LDL^T loses digits on the degenerate and infeasible
endgames (the JAX package's a-posteriori KKT error ratio jumps from 1e-15
to 1e-9..1e5 there), so round-off decides those trajectories: the JAX
package's own drivers end in different outer iterations on the same
problem (SPLIT).  Those cases are held to status and argmin, and outer
iteration by outer iteration to the JAX package's step from its own state
up to the first step whose direction it measures as worse than 1e-10
(ROADMAP R5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onephase_tpu.nlp as jnlp
import onephase_tpu_torch.nlp as tnlp
from onephase_tpu.config import Params as JParams
from onephase_tpu.ipm.core import OnePhaseKernel as JKernel
from onephase_tpu.ops import ldlt as jldlt
from onephase_tpu_torch.config import Params as TParams
from onephase_tpu_torch.ipm.core import OnePhaseKernel as TKernel
from onephase_tpu_torch.ipm.state import RUNNING
from onephase_tpu_torch.ops import ldlt as tldlt
from test_torch_twins import (ZOO_MU_RTOL, ZOO_OPTS, assert_close,
                              check_carried_steps, check_solve_parity,
                              jax_solve, port_solve, qp_pair, zoo_pair)
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SYM = {"kkt.kkt_solver_type": "symmetric"}
CLEVER = {"kkt.kkt_solver_type": "clever_symmetric"}
TRACE_OPTS = {"output_level": 0, "term.max_it": 60}
# round-off-decided cases: (problem, KKT system, options) -> the outer
# iterations of the JAX package's one_phase_solve, of its eigh lane and of
# its BatchSolver at B = 1, 2, 3 from the same start, and the argmin
# tolerance (the JAX package's own runs of toy_lp_inf2 stop up to 2.3e-5
# apart: an infeasibility certificate's x is not unique).  The JAX
# direction's a-posteriori KKT error ratio there: 8.9e-8 at toy_lp_inf2's
# step 6, 1.2e-3 and 1.6e-3 at toy_lp_inf1's step 4.
SPLIT = {
    ("toy_lp_inf2", "symmetric", "zoo"): ((9, 9, 10, 10, 9), 1e-4),
    ("toy_lp_inf1", "symmetric", "trace"): ((11, 6, 6, 7, 8), 1e-6),
    ("toy_lp_inf1", "clever_symmetric", "trace"): ((6, 6, 6, 6, 6), 1e-6),
}
# steps held by check_carried_steps up to its ratio cap of 1e-10: the SPLIT
# cases and toy_lp5 on `symmetric`, whose endgame mu the round-off moves
# by 1e-3 (the JAX ratio is 2.3e-9 at its step 6)
CARRIED = {
    ("toy_lp_inf2", "symmetric", "zoo"): 5,
    ("toy_lp_inf1", "symmetric", "trace"): 3,
    ("toy_lp_inf1", "clever_symmetric", "trace"): 3,
    ("toy_lp5", "symmetric", "zoo"): 5,
}


def _quasi_definite(rng, n, m):
    """tests/test_symmetric_kkt.py:24-31's K: inertia (n, m)."""
    Hm = rng.normal(size=(n, n))
    Hm = Hm @ Hm.T + np.eye(n)
    J = rng.normal(size=(m, n))
    C = np.diag(rng.random(m) + 0.5)
    return np.block([[Hm, J.T], [J, -C]])


@pytest.mark.parametrize("backend", ["ldlt", "eigh"])
def test_factor_kernels_match_jax(backend):
    """A batch of three quasi-definite K (n=6, m=4) and one with a zero
    leading pivot: the factor, the inertia verdicts for (n, m) and
    (n+1, m-1) and the solve equal the JAX package's per instance to 1e-10
    (the eigh pair through its solve and its eigenvalues: eigenvectors
    have no fixed sign); K x = b to 1e-8 on the regular ones."""
    n, m = 6, 4
    rng = np.random.default_rng(0)
    Ks = [_quasi_definite(rng, n, m) for _ in range(3)]
    Kz = _quasi_definite(rng, n, m)
    Kz[0, 0] = 0.0
    Ks.append(Kz)
    b = rng.normal(size=(len(Ks), n + m))
    K = torch.as_tensor(np.stack(Ks))
    if backend == "ldlt":
        L, d = tldlt.ldlt(K)
        x = tldlt.ldlt_solve(L, d, torch.as_tensor(b))
    else:
        L, d = tldlt.eigh_inertia(K)
        x = tldlt.eigh_solve(L, d, torch.as_tensor(b))
    ok = tldlt.inertia_status(d, n, m)
    ok_wrong = tldlt.inertia_status(d, n + 1, m - 1)
    for i, Ki in enumerate(Ks):
        if backend == "ldlt":
            jL, jd = jldlt.ldlt(jnp.asarray(Ki))
            jx = jldlt.ldlt_solve(jL, jd, jnp.asarray(b[i]))
            assert_close(L[i], np.asarray(jL), 1e-10, "L")
        else:
            jL, jd = jldlt.eigh_inertia(jnp.asarray(Ki))
            jx = jldlt.eigh_solve(jL, jd, jnp.asarray(b[i]))
        assert_close(d[i], np.asarray(jd), 1e-10, "d")
        assert_close(x[i], np.asarray(jx), 1e-10, "x")
        assert bool(ok[i]) == bool(jldlt.inertia_status(jd, n, m))
        assert bool(ok_wrong[i]) == bool(
            jldlt.inertia_status(jd, n + 1, m - 1))
    assert ok[:3].all() and not ok_wrong[:3].any()
    if backend == "ldlt":
        assert float(d[3, 0]) == 0.0 and not bool(ok[3])
        rec = L[:3] @ torch.diag_embed(d[:3]) @ L[:3].transpose(-1, -2)
        np.testing.assert_allclose(rec.numpy(), np.stack(Ks[:3]), atol=1e-8)
    np.testing.assert_allclose(
        (K[:3] @ x[:3, :, None])[..., 0].numpy(), b[:3], atol=1e-8)


def _port_direction(name, over, delta):
    tk = TKernel(tnlp.canonicalize(zoo_pair(name)[1], device="cpu"),
                 TParams().with_overrides(over))
    st = tk.initial_state()
    f = tk.form_factor(st.p, st.cache, st.fact)
    dl = torch.full((1,), delta, dtype=torch.float64)
    (L, D), ok = tk.factor(f.Q, dl, f.rescale, fact=f)
    assert bool(ok[0])
    f = f._replace(L=L, D=D, delta=dl)
    z = torch.zeros(1, dtype=torch.float64)
    td, tr = tk.compute_direction(f, st.p, st.cache, z, z, z)
    return {k: getattr(td, k)[0].numpy() for k in "xys"}, float(tr[0]), tk


def _direction_pair(name, opts, lane="xla", delta=1e-8):
    """The first affine direction (eta = 0) at the initial state with the
    factor at `delta`, in each package: ({x, y, s}, ratio, kernel) for the
    JAX package and for the port."""
    jspec, _ = zoo_pair(name)
    over = dict(ZOO_OPTS, **opts, **{"kkt.linear_solver_type": lane})
    jk = JKernel(jnlp.canonicalize(jspec), JParams().with_overrides(over))
    st = jk.initial_state()
    f = jk.form_factor(st.p, st.cache, st.fact)
    (L, D), ok = jk.factor(f.Q, delta, f.rescale)
    assert bool(ok)
    f = f._replace(L=L, D=D, delta=jnp.asarray(delta, jk.dtype))
    jd, jr = jk.compute_direction(f, st.p, st.cache, 0.0, 0.0, 0.0)
    jdir = {k: np.asarray(getattr(jd, k)) for k in "xys"}
    return (jdir, float(jr), jk), _port_direction(name, over, delta)


def _agree(a, b, tol):
    for k in "xys":
        scale = 1.0 + np.abs(a[k]).max()
        assert np.abs(a[k] - b[k]).max() / scale < tol, k


@pytest.mark.parametrize("name", ["toy_lp1", "toy_lp3", "toy_lp5",
                                  "toy_lp7", "rosenbrook2", "circle1"])
def test_direction_agreement(name):
    """tests/test_symmetric_kkt.py:43-66 on the port: the schur and
    symmetric directions agree to 1e-6 with KKT error ratios below 1e-6;
    the symmetric one equals the JAX package's to 1e-10 (the schur
    path's parity is tests/test_torch_core.py's)."""
    sd, sr, _ = _port_direction(name, ZOO_OPTS, 1e-8)
    (jd, _, _), (td, tr, _) = _direction_pair(name, SYM)
    assert sr < 1e-6 and tr < 1e-6
    _agree(jd, td, 1e-10)
    _agree(sd, td, 1e-6)


@pytest.mark.parametrize("name", ["toy_lp5", "toy_lp6"])
def test_clever_direction_agreement(name):
    """tests/test_symmetric_kkt.py:86-113 on the port: the parallel rows
    merge (the same groups as the JAX package's, mr < m) and the reduced
    system reproduces the schur direction to 1e-6; each package's clever
    direction equals the other's to 1e-10."""
    sd, _, _ = _port_direction(name, ZOO_OPTS, 1e-8)
    (jd, _, jk), (td, tr, tk) = _direction_pair(name, CLEVER)
    assert tk.mr == jk.mr < tk.m
    np.testing.assert_array_equal(tk.clever_roots.numpy(), jk.clever_roots)
    np.testing.assert_array_equal(tk.clever_row2group.numpy(),
                                  jk.clever_row2group)
    assert tr < 1e-6
    _agree(jd, td, 1e-10)
    _agree(sd, td, 1e-6)


def _held(name, kkt, tag, opts, lane="xla"):
    """The port's solve against the JAX package's: status, outer
    iterations, argmin to 1e-6 and mu to 1e-8 (ZOO_MU_RTOL's degenerate
    LPs to 1e-6); a SPLIT case status and argmin, and every case of
    CARRIED its carried steps."""
    jspec, tspec = zoo_pair(name)
    rj = jax_solve(jspec, opts, lane=lane)
    rt = port_solve(tspec, opts, lane)
    key = (name, kkt, tag)
    if key in SPLIT:
        counts, x_tol = SPLIT[key]
        assert rj.iterations == counts[0]
        check_solve_parity(rt, rj, x_tol=x_tol, iterations=False)
    elif key in CARRIED:
        check_solve_parity(rt, rj, mu_rtol=None)
    else:
        check_solve_parity(rt, rj, mu_rtol=ZOO_MU_RTOL.get(name, 1e-8))
    if key in CARRIED:
        steps = check_carried_steps(name, opts, lane, ratio_cap=1e-10)
        assert steps == CARRIED[key], steps
    return rt


@pytest.mark.parametrize("name,kkt,expect", [
    ("toy_lp1", "symmetric", "Optimal"),
    ("toy_lp5", "symmetric", "Optimal"),
    ("toy_lp_inf2", "symmetric", "primal_infeasible"),
    ("circle_nc1", "symmetric", "Optimal"),
    ("toy_lp5", "clever_symmetric", "Optimal"),
    ("toy_lp6", "clever_symmetric", "Optimal"),
    ("toy_lp_inf2", "clever_symmetric", "primal_infeasible")])
def test_end_to_end_matches_jax(name, kkt, expect):
    """tests/test_symmetric_kkt.py:69-123's end-to-end cases."""
    rt = _held(name, kkt, "zoo",
               dict(ZOO_OPTS, **{"kkt.kkt_solver_type": kkt}))
    assert rt.status == expect


def _drive(kernel, max_outer=60):
    st = kernel.initial_state()
    states = [st]
    while int(st.status[0]) == RUNNING and len(states) <= max_outer:
        st = kernel.run_chunk(st)
        states.append(st)
    return states


@pytest.mark.parametrize("kkt", ["symmetric", "clever_symmetric"])
@pytest.mark.parametrize("name", ["toy_lp1", "rosenbrook2", "circle1",
                                  "toy_lp_inf1"])
def test_trace_invariants_and_trajectory(name, kkt):
    """tests/test_trace_invariants.py's `symmetric` and `clever` configs
    on the port's iterates (chunks of one outer iteration): I1 slack
    coupling a(x) - s = beta r0 to 1e-9 (relative to 1 + max |r0|), I2
    beta non-increasing, I4 the interior invariant; the solve held to the
    JAX package's as `_held` says."""
    opts = dict(TRACE_OPTS, **{"kkt.kkt_solver_type": kkt})
    _, tspec = zoo_pair(name)
    tk = TKernel(tnlp.canonicalize(tspec, device="cpu"),
                 TParams().with_overrides(dict(opts, chunk_size=1)))
    states = _drive(tk)
    r0 = states[0].r0[0]
    scale = 1.0 + float(r0.abs().max())
    betas = []
    for st in states:
        beta = float(st.p.beta[0])
        drift = float((st.cache.a[0] - st.p.s[0] - beta * r0).abs().max())
        assert drift <= 1e-9 * scale, drift
        assert bool(tk.is_feasible(st.p, tk.pars.ls.comp_feas)[0])
        betas.append(beta)
    assert all(b2 <= b1 * (1 + 1e-12) for b1, b2 in zip(betas, betas[1:]))
    rt = _held(name, kkt, "trace", opts)
    np.testing.assert_allclose(states[-1].p.x[0].numpy(), rt.x, atol=1e-12)


@pytest.mark.parametrize("rmode", ["none", "u_only", "u_and_x"])
def test_clever_rescale_solves(rmode):
    """tests/test_parity_modes.py:104-110 on the port (toy_lp5, whose mu
    is held to 1e-6: ZOO_MU_RTOL)."""
    rt = _held("toy_lp5", "clever_symmetric", "modes", {
        "output_level": 0, "kkt.kkt_solver_type": "clever_symmetric",
        "kkt.kkt_system_rescale": rmode})
    assert rt.status == "Optimal"


def test_clever_rescale_direction_parity():
    """tests/test_parity_modes.py:113-135 on the port: the rescaled
    systems give the unrescaled direction to 1e-6, with KKT error ratios
    below 1e-6, and each equals the JAX package's to 1e-10; the rescale
    vector is the JAX package's."""
    dirs = {}
    for rmode in ("none", "u_only", "u_and_x"):
        (jd, _, _), (td, tr, _) = _direction_pair(
            "toy_lp5", dict(CLEVER, **{"kkt.kkt_system_rescale": rmode}))
        assert tr < 1e-6
        _agree(jd, td, 1e-10)
        dirs[rmode] = td
    for rmode in ("u_only", "u_and_x"):
        _agree(dirs["none"], dirs[rmode], 1e-6)


def test_eigh_backend_direction_and_solve():
    """tests/test_parity_modes.py:140-157 on the port: eigenvalue inertia
    (n positive, mr negative), a direction with KKT error ratio below
    1e-8 equal to the JAX package's to 1e-10, and the solve held to the
    JAX package's."""
    (jd, _, _), (td, tr, tk) = _direction_pair(
        "toy_lp2", SYM, lane="eigh")
    assert tr < 1e-8
    _agree(jd, td, 1e-10)
    st = tk.initial_state()
    f = tk.form_factor(st.p, st.cache, st.fact)
    (V, w), ok = tk.factor(f.Q, torch.full((1,), 1e-8, dtype=torch.float64))
    assert bool(ok[0])
    assert int((w > 0).sum()) == tk.n and int((w < 0).sum()) == tk.mr
    rt = _held("toy_lp2", "symmetric", "modes",
               {"output_level": 0, "kkt.kkt_solver_type": "symmetric"},
               lane="eigh")
    assert rt.status == "Optimal"


@pytest.mark.parametrize("over", [
    SYM, CLEVER, dict(SYM, **{"kkt.linear_solver_type": "eigh"})],
    ids=["symmetric", "clever", "symmetric_eigh"])
def test_batch_matches_jax(over):
    """make_qp(24, 12), batch 3, float64 at tol 1e-6 through both
    packages' BatchSolver: statuses, outer iterations and factorizations
    per instance equal, x to 1e-8."""
    from onephase_tpu.parallel.batch import BatchSolver as JBatch
    from onephase_tpu_torch.parallel.batch import BatchSolver as TBatch
    opts = dict({"output_level": 0, "term.max_it": 60, "chunk_size": 20},
                **over)
    jspec, tspec = qp_pair(24, 12)
    x0s = np.random.default_rng(1).normal(size=(3, 24)) * 0.1
    js = JBatch(jnlp.canonicalize(jspec), JParams().with_overrides(opts))
    jst = js.solve(x0s)
    ts = TBatch(tnlp.canonicalize(tspec, device="cpu"),
                TParams().with_overrides(opts))
    tst = ts.solve(x0s)
    assert ts.statuses(tst) == js.statuses(jst) == ["Optimal"] * 3
    for k in ("t", "cum_fac"):
        np.testing.assert_array_equal(getattr(tst, k).numpy(),
                                      np.asarray(getattr(jst, k)))
    np.testing.assert_allclose(tst.p.x.numpy(), np.asarray(jst.p.x),
                               rtol=0, atol=1e-8)
