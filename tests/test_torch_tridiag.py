"""The port's block-tridiagonal algebra (ops/block_tridiag.py) and the plain
versions of its K5/K7 kernel wrappers (ops/tridiag_pallas.py) against the
JAX package, on the CPU.

Inputs come from seeded numpy generators and go through both packages.
Tolerances: 1e-12 of the largest reference entry in float64 (the same
LAPACK factorizations and triangular solves, summed in other orders); the
Pallas kernels' plain versions in float32 at the JAX test's own absolute
2e-5 (tests/test_tridiag_pallas.py), in float64 at 1e-12 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import onephase_tpu.ops as jops
from onephase_tpu.ops import block_tridiag as jbt
from onephase_tpu.ops import tridiag_pallas as jtp
from onephase_tpu_torch import ops
from onephase_tpu_torch.ops import block_tridiag as tbt
from onephase_tpu_torch.ops import tridiag_pallas as ttp
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _spd_band(K, nb, seed, dtype=np.float64, B=None):
    """tests/test_chain.py's band: A_k = G G^T + 3 I, B_k = 0.3 N(0, 1);
    with a leading batch axis when B is given."""
    rng = np.random.default_rng(seed)
    lead = () if B is None else (B,)
    Ad = rng.normal(size=lead + (K, nb, nb))
    Ad = np.einsum("...kij,...klj->...kil", Ad, Ad) + 3 * np.eye(nb)
    Bs = rng.normal(size=lead + (max(K - 1, 0), nb, nb)) * 0.3
    b = rng.normal(size=lead + (K, nb))
    return Ad.astype(dtype), Bs.astype(dtype), b.astype(dtype)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _rel(got, want, tol):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("K, nb, delta", [(7, 5, 1e-3), (1, 4, 0.0),
                                          (2, 3, 0.5), (12, 8, 1e-3),
                                          (3, 63, 1e-3)])
def test_tridiag_factor_solve_matvec_match_jax(K, nb, delta):
    Ad, Bs, b = _spd_band(K, nb, seed=K + nb)
    jf = jbt.tridiag_factor(jnp.asarray(Ad), jnp.asarray(Bs), delta)
    tf = tbt.tridiag_factor(_t(Ad), _t(Bs), delta)
    assert bool(jf.ok) and bool(tf.ok)
    _rel(tf.Ck, jf.Ck, 1e-12)
    assert tuple(tf.Ek.shape) == (K - 1, nb, nb)
    if K > 1:
        _rel(tf.Ek, jf.Ek, 1e-12)
    _rel(tbt.tridiag_solve(tf, _t(b)), jbt.tridiag_solve(jf, jnp.asarray(b)),
         1e-12)
    _rel(tbt.tridiag_matvec(_t(Ad), _t(Bs), _t(b)),
         jbt.tridiag_matvec(jnp.asarray(Ad), jnp.asarray(Bs),
                            jnp.asarray(b)), 1e-12)


def test_tridiag_batch_axis_equals_single_instances():
    """A leading batch axis with per-instance delta: each instance equals
    the JAX package's unbatched call."""
    Ad, Bs, b = _spd_band(6, 4, seed=11, B=3)
    deltas = np.array([0.0, 1e-3, 0.2])
    tf = tbt.tridiag_factor(_t(Ad), _t(Bs), _t(deltas))
    x = tbt.tridiag_solve(tf, _t(b))
    for i in range(3):
        jf = jbt.tridiag_factor(jnp.asarray(Ad[i]), jnp.asarray(Bs[i]),
                                deltas[i])
        _rel(tf.Ck[i], jf.Ck, 1e-12)
        _rel(x[i], jbt.tridiag_solve(jf, jnp.asarray(b[i])), 1e-12)


@pytest.mark.parametrize("K, nb, P", [(8, 3, 4), (16, 5, 4), (6, 4, 3),
                                      (12, 2, 2)])
def test_partitioned_factor_solve_match_jax(K, nb, P):
    Ad, Bs, b = _spd_band(K, nb, seed=3 * K + nb)
    delta = 1e-3
    jf = jbt.partitioned_factor(jnp.asarray(Ad), jnp.asarray(Bs), delta, P)
    tf = tbt.partitioned_factor(_t(Ad), _t(Bs), delta, P)
    assert bool(jf.ok) and bool(tf.ok)
    for name in ("Gu", "Gv", "Bu", "Vs"):
        _rel(getattr(tf, name), getattr(jf, name), 1e-12)
    _rel(tf.red.Ck, jf.red.Ck, 1e-12)
    _rel(tbt.partitioned_solve(tf, _t(b)),
         jbt.partitioned_solve(jf, jnp.asarray(b)), 1e-12)


@pytest.mark.parametrize("case", ["block", "interior", "separator"])
def test_indefinite_rejected_like_jax(case):
    if case == "block":
        Ad, Bs, _ = _spd_band(4, 3, seed=1)
        Ad[2] -= 10.0 * np.eye(3)
        jok = jbt.tridiag_factor(jnp.asarray(Ad), jnp.asarray(Bs), 0.0).ok
        tok = tbt.tridiag_factor(_t(Ad), _t(Bs), 0.0).ok
    else:
        # K=8, P=4: chunks of 2; stage 4 is an interior, stage 7 a separator
        Ad, Bs, _ = _spd_band(8, 3, seed=4)
        Ad[4 if case == "interior" else 7] -= 50.0 * np.eye(3)
        jok = jbt.partitioned_factor(jnp.asarray(Ad), jnp.asarray(Bs), 0.0,
                                     4).ok
        tok = tbt.partitioned_factor(_t(Ad), _t(Bs), 0.0, 4).ok
    assert not bool(jok) and not bool(tok)


@pytest.fixture
def interpret():
    jops.INTERPRET = True
    try:
        yield
    finally:
        jops.INTERPRET = False


@pytest.mark.parametrize("dt", ["float32", "float64"])
@pytest.mark.parametrize("K, nb", [(8, 3), (6, 16), (1, 5), (12, 8),
                                   (3, 63)])
def test_pallas_wrappers_plain_match_jax_interpret(K, nb, dt, interpret):
    """The wrappers' plain versions (CPU tensors) against the JAX Pallas
    kernels in interpret mode, and no launch counted on the CPU."""
    np_dt = np.dtype(dt)
    Ad, Bs, b = _spd_band(K, nb, seed=3, dtype=np_dt)
    delta = 1e-3
    Ck, Ci, Ek, ok = jtp.pallas_tridiag_factor(
        jnp.asarray(Ad), jnp.asarray(Bs), delta, interpret=True)
    before = ops.launch_counts()
    tCk, tCi, tEk, tok = ttp.pallas_tridiag_factor(_t(Ad)[None],
                                                   _t(Bs)[None], delta)
    assert bool(ok) and tok.tolist() == [True]
    assert tCk.dtype == getattr(torch, dt)
    x = jtp.pallas_tridiag_solve(Ci, Ek, jnp.asarray(b), interpret=True)
    tx = ttp.pallas_tridiag_solve(tCi, tEk, _t(b)[None])
    assert ops.launch_counts() == before
    pairs = [(tCk[0], Ck), (tCi[0], Ci), (tx[0], x)]
    if K > 1:
        pairs.append((tEk[0], Ek))
    for got, want in pairs:
        if dt == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=2e-5)
        else:
            _rel(got, want, 1e-12)


@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_pallas_factor_non_pd_like_jax(dt, interpret):
    Ad, Bs, _ = _spd_band(8, 6, seed=3, dtype=np.dtype(dt))
    Ad[3] -= 50.0 * np.eye(6, dtype=np.dtype(dt))
    jok = jtp.pallas_tridiag_factor(jnp.asarray(Ad), jnp.asarray(Bs), 0.0,
                                    interpret=True)[3]
    tok = ttp.pallas_tridiag_factor(_t(Ad)[None], _t(Bs)[None], 0.0)[3]
    assert not bool(jok) and tok.tolist() == [False]


def test_wrappers_reject_bad_shapes():
    Ad, Bs, b = (_t(a)[None] for a in _spd_band(4, 3, seed=0))
    with pytest.raises(ValueError):
        ttp.pallas_tridiag_factor(Ad, Bs[:, 1:], 0.0)
    with pytest.raises(ValueError):
        ttp.pallas_tridiag_solve(Ad, Bs, b[:, :, :2])
    with pytest.raises(TypeError):
        ttp.pallas_tridiag_factor(Ad.float(), Bs, 0.0)
