"""The port's arrow (block-angular) factor and solve (ops/block_schur.py)
against the JAX package's `arrow_factor`/`arrow_solve` and against a dense
solve of the assembled arrow matrix, on the CPU in float64, at batch
sizes 1 and 3 and on both Cholesky routes (`use_pallas`: the K2 wrapper,
its plain version on the CPU; else cholesky_ex).  Ports the two local
cases of tests/test_block_schur.py.

Tolerances: factors and solution to 1e-12 relative to the largest entry
against the JAX functions, the solution to 1e-9 against the dense solve
(the JAX test's figure).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onephase_tpu.ops.block_schur import arrow_factor as jfactor
from onephase_tpu.ops.block_schur import arrow_solve as jsolve
from onephase_tpu_torch.ops.block_schur import arrow_factor, arrow_solve
from test_torch_twins import assert_close

K, NX, NZ = 8, 6, 4


def make_arrow(seed, K=K, nx=NX, nz=NZ):
    """tests/test_block_schur.py:make_arrow, one instance per seed."""
    rng = np.random.default_rng(seed)
    Qzz = rng.normal(size=(nz, nz))
    Qzz = Qzz @ Qzz.T + 2 * np.eye(nz)
    Qkk = np.zeros((K, nx, nx))
    Bk = rng.normal(size=(K, nx, nz)) * 0.3
    for k in range(K):
        M = rng.normal(size=(nx, nx))
        Qkk[k] = M @ M.T + 2 * np.eye(nx)
    rz = rng.normal(size=nz)
    rk = rng.normal(size=(K, nx))
    return Qzz, Qkk, Bk, rz, rk


def dense_assemble(Qzz, Qkk, Bk, delta):
    K, nx, _ = Qkk.shape
    nz = Qzz.shape[0]
    Q = np.zeros((nz + K * nx, nz + K * nx))
    Q[:nz, :nz] = Qzz
    for k in range(K):
        sl = slice(nz + k * nx, nz + (k + 1) * nx)
        Q[sl, sl] = Qkk[k]
        Q[sl, :nz] = Bk[k]
        Q[:nz, sl] = Bk[k].T
    return Q + delta * np.eye(Q.shape[0])


def _batch(insts):
    """Stack per-instance numpy tuples into batch-first float64 tensors."""
    return [torch.as_tensor(np.stack(a)) for a in zip(*insts)]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("B", [1, 3])
def test_arrow_matches_jax_and_dense(B, use_pallas):
    insts = [make_arrow(seed) for seed in range(B)]
    deltas = [1e-3 * (b + 1) for b in range(B)]
    Qzz, Qkk, Bk, rz, rk = _batch(insts)
    f = arrow_factor(Qzz, Qkk, Bk, torch.tensor(deltas, dtype=torch.float64),
                     use_pallas=use_pallas)
    assert f.ok.tolist() == [True] * B
    dz, dxk = arrow_solve(f, Bk, rz, rk)
    for b, (inst, delta) in enumerate(zip(insts, deltas)):
        qzz, qkk, bk, r_z, r_k = inst
        jf = jfactor(jnp.asarray(qzz), jnp.asarray(qkk), jnp.asarray(bk),
                     delta)
        assert bool(jf.ok)
        assert_close(f.Lk[b].numpy(), jf.Lk, 1e-12, "Lk")
        assert_close(f.LS[b].numpy(), jf.LS, 1e-12, "LS")
        jdz, jdxk = jsolve(jf, jnp.asarray(bk), jnp.asarray(r_z),
                           jnp.asarray(r_k))
        assert_close(dz[b].numpy(), jdz, 1e-12, "dz")
        assert_close(dxk[b].numpy(), jdxk, 1e-12, "dxk")
        sol = np.linalg.solve(dense_assemble(qzz, qkk, bk, delta),
                              np.concatenate([r_z, r_k.ravel()]))
        np.testing.assert_allclose(dz[b].numpy(), sol[:NZ], atol=1e-9)
        np.testing.assert_allclose(dxk[b].numpy().ravel(), sol[NZ:],
                                   atol=1e-9)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("where", ["block", "border"])
def test_arrow_inertia_detects_indefinite(where, use_pallas):
    """An indefinite scenario block (tests/test_block_schur.py:59-69) or an
    indefinite border S gives ok False for that instance alone; a large
    delta restores definiteness.  The JAX package agrees on each flag."""
    insts = [list(make_arrow(seed)) for seed in range(3)]
    if where == "block":
        insts[1][1][2] -= 10 * np.eye(NX)
    else:
        # every block stays definite; Qzz - sum B^T Q^-1 B does not
        insts[1][0] = insts[1][0] - 50 * np.eye(NZ)
    Qzz, Qkk, Bk, _, _ = _batch(insts)
    for delta, want in ((0.0, [True, False, True]),
                        (60.0, [True, True, True])):
        d = torch.full((3,), delta, dtype=torch.float64)
        f = arrow_factor(Qzz, Qkk, Bk, d, use_pallas=use_pallas)
        assert f.ok.tolist() == want, (where, delta)
        jok = [bool(jfactor(jnp.asarray(q), jnp.asarray(k), jnp.asarray(b),
                            delta).ok) for q, k, b, _, _ in insts]
        assert jok == want
    if where == "border":
        # the blocks alone are fine: only the border failed
        blocks = torch.linalg.cholesky_ex(Qkk[1])[1]
        assert (blocks == 0).all()
