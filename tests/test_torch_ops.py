"""The port's kernel modules against the JAX package's kernels.

On the CPU every wrapper runs its plain PyTorch version; those are held to
the JAX functions (the Pallas kernels in interpret mode where they lower on
the CPU, `xla_fused_q` for K1, whose Pallas kernel does not lower here).
The CUDA kernels themselves are held to these plain versions on the card by
tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onephase_tpu.ops as jops
from onephase_tpu.ops import cholesky as jchol
from onephase_tpu.ops import refine as jref
from onephase_tpu.ops import schur as jschur
from onephase_tpu_torch import ops as tops
from onephase_tpu_torch.ops import cholesky as tchol
from onephase_tpu_torch.ops import refine as tref
from onephase_tpu_torch.ops import schur as tschur
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# max |port - JAX| / max |JAX| by dtype: f64 agrees to rounding; f32
# products of length m ~ 100 and factorizations of n <= 256 stay within
# 1e-5 of the largest entry
RTOL = {np.float64: 1e-12, np.float32: 1e-5}
TDT = {np.float64: torch.float64, np.float32: torch.float32}


def _rel_err(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _spd(rng, n, dt, shift=None):
    A = rng.normal(size=(n, n))
    return (A @ A.T + (n if shift is None else shift) * np.eye(n)).astype(dt)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("n, m, shared, with_h", [
    (40, 24, True, True), (130, 70, False, True), (64, 0, True, True),
    (33, 17, True, False)])
def test_fused_q_plain_matches_jax(dt, n, m, shared, with_h):
    rng = np.random.default_rng(n + m)
    B = 3
    Jc = rng.normal(size=(m, n) if shared else (B, m, n)).astype(dt)
    w = rng.uniform(0.1, 10.0, size=(B, m)).astype(dt)
    H = np.stack([_spd(rng, n, dt) for _ in range(B)]) if with_h else None
    bnd = rng.uniform(0.0, 5.0, size=(B, n)).astype(dt)
    t = lambda a: None if a is None else torch.as_tensor(a)  # noqa: E731
    got = tschur.pallas_fused_q(t(Jc), t(w), t(H), t(bnd))
    assert got.dtype == TDT[dt] and got.shape == (B, n, n)
    for b in range(B):
        want = jschur.xla_fused_q(jnp.asarray(Jc if shared else Jc[b]),
                                  jnp.asarray(w[b]),
                                  None if H is None else jnp.asarray(H[b]),
                                  jnp.asarray(bnd[b]))
        assert _rel_err(got[b], want) <= RTOL[dt]


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("m, n, seed, hsym", [
    (40, 30, 11, True), (300, 150, 11, True), (96, 64, 7, False),
    (300, 200, 7, False), (96, 130, 7, True)])
def test_fused_q_tri_matches_jax(dt, m, n, seed, hsym):
    """The port's `pallas_fused_q_tri` (on CPU tensors: its plain version)
    against the JAX package's triangle-tiled Pallas kernel in interpret mode
    and against its `xla_fused_q`, at the shapes of tests/test_kkt.py and
    tests/test_parity_modes.py (single-tile, multi-tile and ragged grids)."""
    rng = np.random.default_rng(seed)
    Jc = rng.normal(size=(m, n)).astype(dt)
    w = rng.uniform(0.1, 5.0, size=m).astype(dt)
    H0 = rng.normal(size=(n, n)).astype(dt)
    H = H0 + H0.T if hsym else H0 @ H0.T
    bnd = rng.uniform(0.0, 1.0, size=n).astype(dt)
    got = tschur.pallas_fused_q_tri(
        torch.as_tensor(Jc), torch.as_tensor(w)[None], torch.as_tensor(H),
        torch.as_tensor(bnd)[None])
    assert got.dtype == TDT[dt] and got.shape == (1, n, n)
    args = [jnp.asarray(a) for a in (Jc, w, H, bnd)]
    assert _rel_err(got[0], jschur.xla_fused_q(*args)) <= RTOL[dt]
    assert _rel_err(got[0], jschur.pallas_fused_q_tri(
        *args, interpret=True)) <= RTOL[dt]


def test_fused_q_tri_checks_operands_like_fused_q():
    """Both kernel wrappers share the operand checks; on a device with no
    kernel they raise instead of running the plain version."""
    meta = lambda *s: torch.zeros(*s, dtype=torch.float64,   # noqa: E731
                                  device="meta")
    for fq in (tschur.pallas_fused_q, tschur.pallas_fused_q_tri):
        with pytest.raises(ValueError, match="no kernel for device"):
            fq(meta(3, 4), meta(1, 3), None, meta(1, 4))


@pytest.fixture
def interpret():
    jops.INTERPRET = True
    try:
        yield
    finally:
        jops.INTERPRET = False


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("n", [40, 130, 256])
def test_chol_and_tri_inv_gram_plain_match_pallas(dt, n, interpret):
    rng = np.random.default_rng(n)
    Q = _spd(rng, n, dt)
    L, d, ok = tchol.pallas_chol(torch.as_tensor(Q)[None])
    Lj, dj, okj = jchol.pallas_chol(jnp.asarray(Q), interpret=True)
    assert bool(ok[0]) and bool(okj)
    assert _rel_err(L[0], Lj) <= RTOL[dt]
    assert _rel_err(d[0], dj) <= RTOL[dt]
    M = tchol.pallas_tri_inv_gram(L)
    assert _rel_err(M[0], jchol.pallas_tri_inv_gram(jnp.asarray(Lj),
                                                    interpret=True)) <= 10 * RTOL[dt]
    assert _rel_err(M[0], jchol.xla_chol_inv_from_L(jnp.asarray(Lj))) \
        <= 10 * RTOL[dt]
    M4, d4, ok4 = tchol.pallas_chol_inv(torch.as_tensor(Q)[None])
    assert bool(ok4[0])
    torch.testing.assert_close(M4, M, rtol=0, atol=0)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_chol_rejects_non_pd_like_pallas(dt, interpret):
    rng = np.random.default_rng(3)
    Q = _spd(rng, 40, dt, shift=3.0) - 50.0 * np.eye(40, dtype=dt)
    _, _, ok = tchol.pallas_chol(torch.as_tensor(Q)[None])
    _, _, okj = jchol.pallas_chol(jnp.asarray(Q), interpret=True)
    assert not bool(ok[0]) and not bool(okj)


@pytest.mark.parametrize("n", [5, 300, 520])
def test_blocked_tri_inv_matches_jax(n):
    """Single-block, padded multi-block and batched paths."""
    rng = np.random.default_rng(n)
    Ls = np.stack([np.linalg.cholesky(_spd(rng, n, np.float64))
                   for _ in range(2)])
    got = tchol.blocked_tri_inv(torch.as_tensor(Ls))
    for b in range(2):
        want = jchol.blocked_tri_inv(jnp.asarray(Ls[b]))
        assert _rel_err(got[b], want) <= 1e-12


def test_cpu_wrappers_launch_nothing():
    tops.reset_launch_counts()
    Q = torch.eye(8, dtype=torch.float64)[None] * 2.0
    L, _, _ = tchol.pallas_chol(Q)
    tchol.pallas_tri_inv_gram(L)
    for fq in (tschur.pallas_fused_q, tschur.pallas_fused_q_tri):
        fq(torch.zeros(0, 8, dtype=torch.float64),
           torch.zeros(1, 0, dtype=torch.float64), None,
           torch.ones(1, 8, dtype=torch.float64))
    from onephase_tpu_torch.ops import tridiag_pallas as ttp
    Ad = torch.eye(3, dtype=torch.float64).expand(1, 4, 3, 3) * 2.0
    _, Ci, Ek, _ = ttp.pallas_tridiag_factor(Ad, torch.zeros(1, 3, 3, 3,
                                             dtype=torch.float64), 0.0)
    ttp.pallas_tridiag_solve(Ci, Ek, torch.ones(1, 4, 3, dtype=torch.float64))
    assert tops.launch_counts() == {"fused_q": 0, "fused_q_tri": 0, "chol": 0,
                                    "tri_inv_gram": 0, "tridiag_factor": 0,
                                    "tridiag_solve": 0}


# ---------------------------------------------------------------------------
# double-single arithmetic
@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_two_sum_two_prod_error_terms_exact(dt):
    rng = np.random.default_rng(11)
    a = (rng.normal(size=4096) * 10.0 ** rng.uniform(-8, 8, 4096)).astype(dt)
    b = (rng.normal(size=4096) * 10.0 ** rng.uniform(-8, 8, 4096)).astype(dt)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    for tf, jf in ((tref.two_sum, jref.two_sum), (tref.two_prod, jref.two_prod),
                   (lambda x, y: tref.split(x), lambda x, y: jref.split(x))):
        got = tf(ta, tb)
        want = jf(jnp.asarray(a), jnp.asarray(b))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    hi, lo = tref.ds_add(ta, tb, tb, ta)
    jhi, jlo = jref.ds_add(*(jnp.asarray(v) for v in (a, b, b, a)))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))


def test_ds_matvec_double_single_accuracy():
    """hi + lo of the f32 double-single matvec is ~1e-13 accurate, as the
    JAX package's (both against the exact f64 product of the f32 data)."""
    rng = np.random.default_rng(5)
    A = rng.normal(size=(33, 257)).astype(np.float32)
    X = rng.normal(size=(3, 257)).astype(np.float32)
    exact = X.astype(np.float64) @ A.astype(np.float64).T
    hi, lo = tref.ds_matvec(torch.as_tensor(A), torch.as_tensor(X))
    got = hi.double().numpy() + lo.double().numpy()
    scale = np.abs(exact).max()
    assert np.abs(got - exact).max() / scale < 1e-13
    for b in range(3):
        jhi, jlo = jref.ds_matvec(jnp.asarray(A), jnp.asarray(X[b]))
        jsum = np.asarray(jhi, np.float64) + np.asarray(jlo, np.float64)
        assert np.abs(got[b] - jsum).max() / scale < 1e-13
    ax_hi, ax_lo = tref.ds_axpy(3.0, torch.as_tensor(X), torch.zeros_like(
        torch.as_tensor(X)), torch.as_tensor(X), torch.zeros_like(
        torch.as_tensor(X)))
    np.testing.assert_allclose(ax_hi.double().numpy() + ax_lo.double().numpy(),
                               4.0 * X.astype(np.float64), rtol=1e-14)
