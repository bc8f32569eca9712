"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips where there is no CUDA card (the
kernels have no CPU mode).  The file imports neither JAX nor the JAX
package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

(`--noconftest`: tests/conftest.py configures JAX for the other tests.)
Inputs come from seeded numpy generators.  Tolerance: max |kernel - plain|
over max |plain|, 1e-4 in float32 and 1e-10 in float64 (different
summation orders; factorizations of well-conditioned SPD matrices).
"""

import numpy as np
import pytest
import torch

from onephase_tpu_torch import ops
from onephase_tpu_torch.ops import cholesky as ch
from onephase_tpu_torch.ops import schur

TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel_err(got, want):
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max())


def _spd(rng, B, n, dt, dev):
    """A A^T + n I, formed in float64."""
    A = rng.normal(size=(B, n, n))
    Q = A @ A.transpose(0, 2, 1) + n * np.eye(n)
    return torch.as_tensor(Q, dtype=dt, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, m, B, shared, with_h", [
    (256, 128, 16, True, True), (130, 70, 3, False, True),
    (64, 0, 2, True, True), (100, 40, 2, True, False)])
def test_fused_q_matches_plain(cuda, dt, n, m, B, shared, with_h):
    rng = np.random.default_rng(n + m)

    def t(a):
        return torch.as_tensor(a, dtype=dt, device=cuda)

    Jc = t(rng.normal(size=(m, n) if shared else (B, m, n)) / np.sqrt(n))
    w = t(rng.uniform(0.1, 10.0, size=(B, m)))
    H = (_spd(rng, 1, n, dt, cuda)[0] if shared else
         _spd(rng, B, n, dt, cuda)) if with_h else None
    bnd = t(rng.uniform(0.0, 5.0, size=(B, n)))
    before = ops.launch_counts()["fused_q"]
    got = schur.pallas_fused_q(Jc, w, H, bnd)
    assert ops.launch_counts()["fused_q"] == before + 1
    assert _rel_err(got, schur.xla_fused_q(Jc, w, H, bnd)) <= TOL[dt]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, B", [(256, 16), (130, 3), (1024, 4)])
def test_chol_tri_inv_gram_chol_inv_match_plain(cuda, dt, n, B):
    Q = _spd(np.random.default_rng(n), B, n, dt, cuda)
    before = ops.launch_counts()
    L, d, ok = ch.pallas_chol(Q)
    Lr, dr, okr = ch.xla_chol(Q)
    assert bool(ok.all()) and bool(okr.all())
    assert _rel_err(L, Lr) <= TOL[dt] and _rel_err(d, dr) <= TOL[dt]
    M = ch.pallas_tri_inv_gram(L)
    assert _rel_err(M, ch.xla_chol_inv_from_L(Lr)) <= TOL[dt]
    M4, d4, ok4 = ch.pallas_chol_inv(Q)
    assert bool(ok4.all())
    assert _rel_err(M4, M) <= TOL[dt] and _rel_err(d4, d) <= TOL[dt]
    after = ops.launch_counts()
    assert after["chol"] == before["chol"] + 2
    assert after["tri_inv_gram"] == before["tri_inv_gram"] + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_chol_rejects_non_pd(cuda, dt):
    Q = _spd(np.random.default_rng(7), 4, 130, dt, cuda)
    Q = Q - 1e3 * 130 * torch.eye(130, dtype=dt, device=cuda)
    assert not bool(ch.pallas_chol(Q)[2].any())
    assert not bool(ch.xla_chol(Q)[2].any())
