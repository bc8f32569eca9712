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
@pytest.mark.parametrize("n, m, B, shared, with_h", [
    (256, 128, 16, True, True), (130, 70, 3, False, True),
    (64, 0, 2, True, True), (40, 30, 2, False, True),
    (200, 300, 2, True, False)])
def test_fused_q_tri_matches_plain_and_is_symmetric(cuda, dt, n, m, B, shared,
                                                    with_h):
    """K6 against the plain version and against K1; Q - H symmetric bit for
    bit (H itself is made bit-symmetric here); an unsymmetric H is added
    where it stands, H[j, i] in the mirrored tile."""
    rng = np.random.default_rng(n + m)

    def t(a):
        return torch.as_tensor(a, dtype=dt, device=cuda)

    Jc = t(rng.normal(size=(m, n) if shared else (B, m, n)) / np.sqrt(n))
    w = t(rng.uniform(0.1, 10.0, size=(B, m)))
    H = (_spd(rng, 1, n, dt, cuda)[0] if shared else
         _spd(rng, B, n, dt, cuda)) if with_h else None
    if H is not None:
        H = (0.5 * (H + H.transpose(-1, -2))).contiguous()
    bnd = t(rng.uniform(0.0, 5.0, size=(B, n)))
    before = ops.launch_counts()["fused_q_tri"]
    got = schur.pallas_fused_q_tri(Jc, w, H, bnd)
    assert ops.launch_counts()["fused_q_tri"] == before + 1
    assert _rel_err(got, schur.xla_fused_q(Jc, w, H, bnd)) <= TOL[dt]
    assert _rel_err(got, schur.pallas_fused_q(Jc, w, H, bnd)) <= TOL[dt]
    assert torch.equal(got, got.transpose(-1, -2))
    if H is not None:
        skew = t(rng.normal(size=H.shape))
        got = schur.pallas_fused_q_tri(Jc, w, H + skew, bnd)
        assert _rel_err(got, schur.xla_fused_q(Jc, w, H + skew, bnd)) \
            <= TOL[dt]


# K1 on both sides of its 64 and 128 tile edges, on the 64-edge grid and
# (B T of 128-tiles at least two blocks per SM of the H100) the 128-edge
# one, on the 16-byte and the one-element copy routes, m = 0, a ragged k
# tail (m not a multiple of the 16-row slab) and m > n
FQ_EDGES = [(63, 70, 3, False), (64, 0, 2, True), (65, 1, 5, True),
            (127, 70, 64, True), (128, 128, 64, False), (129, 0, 64, True),
            (130, 37, 3, False), (250, 37, 96, True), (256, 128, 96, True),
            (258, 300, 64, False)]


def _fq_inputs(rng, n, m, B, shared, dt, dev):
    """Jc ~ N(0, 1/n), w in [0.1, 10], an unsymmetric H ~ N(0, 1), bnd."""
    def t(a):
        return torch.as_tensor(a, dtype=dt, device=dev)

    Jc = t(rng.normal(size=(m, n) if shared else (B, m, n)) / np.sqrt(n))
    w = t(rng.uniform(0.1, 10.0, size=(B, m)))
    H = t(rng.normal(size=(n, n) if shared else (B, n, n)))
    bnd = t(rng.uniform(0.0, 5.0, size=(B, n)))
    return Jc, w, H, bnd


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, m, B, shared", FQ_EDGES)
def test_fused_q_edges_and_exact_symmetry(cuda, dt, n, m, B, shared):
    """K1 against the plain version at ragged edges; its rank-m part (H =
    None, bnd = 0) bit-symmetric; and with an unsymmetric H, Q = (H + that
    part) + diag(bnd) bit for bit: H[i, j] is added where it stands, above
    the diagonal too."""
    Jc, w, H, bnd = _fq_inputs(np.random.default_rng(n * 7 + m), n, m, B,
                               shared, dt, cuda)
    before = ops.launch_counts()["fused_q"]
    Q = schur.pallas_fused_q(Jc, w, H, bnd)
    assert ops.launch_counts()["fused_q"] == before + 1
    assert _rel_err(Q, schur.xla_fused_q(Jc, w, H, bnd)) <= TOL[dt]
    R = schur.pallas_fused_q(Jc, w, None, torch.zeros_like(bnd))
    assert torch.equal(R, R.mT)
    assert torch.equal(Q, (H + R) + torch.diag_embed(bnd))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, m, B, shared", FQ_EDGES + [(1024, 512, 64, True)])
def test_fused_q_lower_triangle_equals_fused_q_tri(cuda, dt, n, m, B,
                                                  shared):
    """K1's and K6's lower triangles (the diagonal included) are equal bit
    for bit: both sum (Jc[k, i] w[k]) Jc[k, j] over k in order with one FMA
    a term, then add H and, on the diagonal, bnd."""
    Jc, w, H, bnd = _fq_inputs(np.random.default_rng(n * 11 + m), n, m, B,
                               shared, dt, cuda)
    assert torch.equal(torch.tril(schur.pallas_fused_q(Jc, w, H, bnd)),
                       torch.tril(schur.pallas_fused_q_tri(Jc, w, H, bnd)))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, m, B, shared", FQ_EDGES + [(1024, 512, 64, True)])
@pytest.mark.parametrize("with_h", [True, False])
def test_fused_q_tri_equals_fused_q_bit_for_bit(cuda, dt, n, m, B, shared,
                                                with_h):
    """K6 runs K1's kernel: with a symmetric H (or none) the two wrappers
    return the same full Q, both triangles, bit for bit, each counting its
    own launch."""
    Jc, w, H, bnd = _fq_inputs(np.random.default_rng(n * 13 + m), n, m, B,
                               shared, dt, cuda)
    H = (0.5 * (H + H.mT)).contiguous() if with_h else None
    before = ops.launch_counts()
    Q6 = schur.pallas_fused_q_tri(Jc, w, H, bnd)
    Q1 = schur.pallas_fused_q(Jc, w, H, bnd)
    after = ops.launch_counts()
    assert after["fused_q_tri"] == before["fused_q_tri"] + 1
    assert after["fused_q"] == before["fused_q"] + 1
    assert torch.equal(Q6, Q1)
    assert torch.equal(Q6 - torch.diag_embed(bnd),
                       (Q6 - torch.diag_embed(bnd)).mT)


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
    assert torch.equal(M, M.mT)
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


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("B, n", [(256, 64), (64, 16), (64, 1), (1, 1)])
def test_chol_at_scenario_shapes(cuda, dt, B, n):
    """K2 on the scenario path's blocks and borders, down to 1 x 1."""
    Q = _spd(np.random.default_rng(B + n), B, n, dt, cuda)
    L, d, ok = ch.pallas_chol(Q)
    Lr, dr, okr = ch.xla_chol(Q)
    assert bool(ok.all()) and bool(okr.all())
    assert _rel_err(L, Lr) <= TOL[dt] and _rel_err(d, dr) <= TOL[dt]
    assert not bool(ch.pallas_chol(-Q)[2].any())


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("nz", [16, 1])
def test_arrow_factor_on_k2_matches_plain(cuda, dt, nz):
    """The arrow factor with K2 (two launches: blocks, border) against the
    cholesky_ex route, and its solve; an indefinite block and an indefinite
    border flag their instance alone."""
    from onephase_tpu_torch.ops.block_schur import arrow_factor, arrow_solve
    rng = np.random.default_rng(nz)
    B, K, nx = 3, 64, 16
    Qkk = _spd(rng, B * K, nx, dt, cuda).reshape(B, K, nx, nx)
    Qzz = _spd(rng, B, nz, dt, cuda) * K
    Bk = torch.as_tensor(rng.normal(size=(B, K, nx, nz)) * 0.3, dtype=dt,
                         device=cuda)
    delta = torch.full((B,), 1e-6, dtype=dt, device=cuda)
    before = ops.launch_counts()["chol"]
    f = arrow_factor(Qzz, Qkk, Bk, delta, use_pallas=True)
    assert ops.launch_counts()["chol"] == before + 2
    fr = arrow_factor(Qzz, Qkk, Bk, delta)
    assert f.ok.tolist() == fr.ok.tolist() == [True] * B
    assert _rel_err(f.Lk, fr.Lk) <= TOL[dt] and _rel_err(f.LS, fr.LS) <= TOL[dt]
    rz = torch.as_tensor(rng.normal(size=(B, nz)), dtype=dt, device=cuda)
    rk = torch.as_tensor(rng.normal(size=(B, K, nx)), dtype=dt, device=cuda)
    (dz, dx), (dzr, dxr) = arrow_solve(f, Bk, rz, rk), arrow_solve(fr, Bk, rz, rk)
    assert _rel_err(dz, dzr) <= TOL[dt] and _rel_err(dx, dxr) <= TOL[dt]
    Qkk[1, 5] -= 1e3 * torch.eye(nx, dtype=dt, device=cuda)
    Qzz[2] -= 1e6 * torch.eye(nz, dtype=dt, device=cuda)
    f = arrow_factor(Qzz, Qkk, Bk, delta, use_pallas=True)
    assert f.ok.tolist() == [True, False, False]


def _band(rng, B, K, nb, dt, dev, shift=3.0):
    """Block-tridiagonal SPD band: A_k = G G^T + shift I, B_k ~ 0.3 N(0, 1)."""
    G = rng.normal(size=(B, K, nb, nb))
    Ad = G @ G.transpose(0, 1, 3, 2) + shift * np.eye(nb)
    Bs = rng.normal(size=(B, max(K - 1, 0), nb, nb)) * 0.3
    return (torch.as_tensor(Ad, dtype=dt, device=dev),
            torch.as_tensor(Bs, dtype=dt, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("B, K, nb", [(1, 400, 32), (3, 7, 30), (2, 1, 32),
                                      (2, 12, 5), (1, 9, 64), (1, 204, 63),
                                      (1, 200, 64)])
def test_tridiag_factor_and_solve_match_plain(cuda, dt, B, K, nb):
    from onephase_tpu_torch.ops import tridiag_pallas as tp
    rng = np.random.default_rng(K * 100 + nb)
    Ad, Bs = _band(rng, B, K, nb, dt, cuda)
    delta = torch.as_tensor(rng.uniform(0.0, 1e-3, size=B), dtype=dt,
                            device=cuda)
    before = ops.launch_counts()
    Ck, Ci, Ek, ok = tp.pallas_tridiag_factor(Ad, Bs, delta)
    Ckr, Cir, Ekr, okr = tp.xla_tridiag_factor_inv(Ad, Bs, delta)
    assert bool(ok.all()) and bool(okr.all())
    assert _rel_err(Ck, Ckr) <= TOL[dt] and _rel_err(Ci, Cir) <= TOL[dt]
    if K > 1:
        assert _rel_err(Ek, Ekr) <= TOL[dt]
    b = torch.as_tensor(rng.normal(size=(B, K, nb)), dtype=dt, device=cuda)
    x = tp.pallas_tridiag_solve(Ci, Ek, b)
    assert _rel_err(x, tp.xla_tridiag_solve_inv(Cir, Ekr, b)) <= TOL[dt]
    after = ops.launch_counts()
    assert after["tridiag_factor"] == before["tridiag_factor"] + 1
    assert after["tridiag_solve"] == before["tridiag_solve"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("B, K, nb", [(2, 1, 1), (3, 1, 30), (1, 1, 64),
                                      (2, 2, 31), (1, 9, 32), (3, 20, 5),
                                      (2, 17, 33), (1, 13, 63), (2, 40, 63),
                                      (1, 7, 64)])
def test_tridiag_solve_every_width_and_ring_wrap(cuda, dt, B, K, nb):
    """K5 on both of its compile-time block edges (32 and 64) and their
    ragged widths, at K = 1 (one stage each way) and at K past the depth of
    its stage ring (8 slots at nb <= 32 in f32, 3 at nb > 32 in f64), against
    `xla_tridiag_solve_inv` on the same block inverses; one launch counted
    a call."""
    from onephase_tpu_torch.ops import tridiag_pallas as tp
    rng = np.random.default_rng(K * 1000 + nb * 10 + B)
    Ad, Bs = _band(rng, B, K, nb, dt, cuda)
    Ck, Ci, Ek, ok = tp.pallas_tridiag_factor(Ad, Bs, 1e-4)
    assert bool(ok.all())
    b = torch.as_tensor(rng.normal(size=(B, K, nb)), dtype=dt, device=cuda)
    before = ops.launch_counts()["tridiag_solve"]
    x = tp.pallas_tridiag_solve(Ci, Ek, b)
    assert ops.launch_counts()["tridiag_solve"] == before + 1
    assert _rel_err(x, tp.xla_tridiag_solve_inv(Ci, Ek, b)) <= TOL[dt]
    # the residual of the block-tridiagonal system itself
    A = Ad + 1e-4 * torch.eye(nb, dtype=dt, device=cuda)
    r = torch.einsum("bkij,bkj->bki", A, x)
    if K > 1:
        r[:, 1:] += torch.einsum("bkij,bkj->bki", Bs, x[:, :-1])
        r[:, :-1] += torch.einsum("bkji,bkj->bki", Bs, x[:, 1:])
    assert _rel_err(r, b) <= 10 * TOL[dt]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_tridiag_factor_rejects_non_pd(cuda, dt):
    from onephase_tpu_torch.ops import tridiag_pallas as tp
    Ad, Bs = _band(np.random.default_rng(5), 3, 8, 6, dt, cuda)
    Ad[1, 3] -= 50.0 * torch.eye(6, dtype=dt, device=cuda)
    ok = tp.pallas_tridiag_factor(Ad, Bs, 0.0)[3]
    okr = tp.xla_tridiag_factor_inv(Ad, Bs, 0.0)[3]
    assert ok.tolist() == okr.tolist() == [True, False, True]


def _spd_on_card(rng, B, n, dt, dev):
    """A A^T + n I with A from the seeded generator, formed on the card in
    float64 (numpy would take minutes at n = 1024, B = 64)."""
    A = torch.as_tensor(rng.normal(size=(B, n, n)), dtype=torch.float64,
                        device=dev)
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    return (A @ A.transpose(-1, -2) + n * eye).to(dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 3, 16, 64])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 130, 256, 1024])
def test_chol_matches_xla_chol(cuda, dt, n, B):
    """K2 at every cluster size its rule picks (8 at B <= 16, 2 at B = 64)
    and at ragged panels, against `xla_chol`."""
    Q = _spd_on_card(np.random.default_rng(1000 * n + B), B, n, dt, cuda)
    before = ops.launch_counts()["chol"]
    L, d, ok = ch.pallas_chol(Q)
    Lr, dr, okr = ch.xla_chol(Q)
    assert ops.launch_counts()["chol"] == before + 1
    assert ok.tolist() == okr.tolist() == [True] * B
    assert _rel_err(L, Lr) <= TOL[dt] and _rel_err(d, dr) <= TOL[dt]
    assert bool((torch.triu(L, 1) == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 3, 16])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 63, 64, 65])
def test_tri_inv_gram_every_tile_edge(cuda, dt, n, B):
    """K3 across the edges of its tiles (32-row chunks and 64-column blocks
    of the triangular inverse, 64-wide Gram tiles) against the plain
    version, one launch counted per call; M symmetric bit for bit."""
    Q = _spd_on_card(np.random.default_rng(2000 * n + B), B, n, dt, cuda)
    L = ch.xla_chol(Q)[0].contiguous()
    before = ops.launch_counts()["tri_inv_gram"]
    M = ch.pallas_tri_inv_gram(L)
    assert ops.launch_counts()["tri_inv_gram"] == before + 1
    assert _rel_err(M, ch.xla_chol_inv_from_L(L)) <= TOL[dt]
    assert torch.equal(M, M.mT)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, B", [(300, 48), (1030, 8)])
def test_tri_inv_gram_on_the_128_tile_grid(cuda, dt, n, B):
    """K3's Gram half where B x (lower 128-tile pairs) gives every SM of an
    H100 two blocks, so f32 takes the 128-tile grid (each tile's k loop
    from its row i0, ragged n) and f64 its 64-tile one: against the plain
    version, M symmetric bit for bit."""
    Q = _spd_on_card(np.random.default_rng(3000 * n + B), B, n, dt, cuda)
    L = ch.xla_chol(Q)[0].contiguous()
    M = ch.pallas_tri_inv_gram(L)
    assert _rel_err(M, ch.xla_chol_inv_from_L(L)) <= TOL[dt]
    assert torch.equal(M, M.mT)


@pytest.mark.gpu
def test_tri_inv_gram_ill_conditioned(cuda):
    """Q = U diag(s) U^T in float32, s log-spaced down to 1e-6, U
    orthogonal: the inverse of its factor loses about cond * eps in either
    version, so K3 is held to the float64 inverse of the same L no worse
    than 10x the plain version's error (both are forward substitutions with
    the same first-order error bound; the factor covers their different
    summation orders).  M stays finite and symmetric bit for bit."""
    dt, cond, n, B = torch.float32, 1e6, 256, 4
    rng = np.random.default_rng(11)
    A = torch.as_tensor(rng.normal(size=(B, n, n)), dtype=torch.float64,
                        device=cuda)
    U = torch.linalg.qr(A)[0]
    s = torch.logspace(0.0, -np.log10(cond), n, dtype=torch.float64,
                       device=cuda)
    Q = (U * s) @ U.mT
    L, _, ok = ch.xla_chol((0.5 * (Q + Q.mT)).to(dt))
    assert bool(ok.all())
    L = L.contiguous()
    ref = ch.xla_chol_inv_from_L(L.double())
    M = ch.pallas_tri_inv_gram(L)
    assert bool(torch.isfinite(M).all()) and torch.equal(M, M.mT)
    assert _rel_err(M, ref) <= 10 * _rel_err(ch.xla_chol_inv_from_L(L), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_chol_flags_only_the_instance_with_a_late_bad_pivot(cuda, dt):
    """The first bad pivot of instance 1 lies in the third 64-column panel;
    its neighbours are SPD and keep ok."""
    Q = _spd_on_card(np.random.default_rng(9), 3, 200, dt, cuda)
    Q[1, 150, 150] = -1.0
    ok = ch.pallas_chol(Q)[2]
    okr = ch.xla_chol(Q)[2]
    assert ok.tolist() == okr.tolist() == [True, False, True]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb", [1, 31, 32, 33, 63, 64])
def test_tridiag_factor_every_tile_width(cuda, dt, nb):
    """K7 on both of its compile-time tile widths (32 and 64) and their
    ragged edges, against `xla_tridiag_factor_inv`."""
    from onephase_tpu_torch.ops import tridiag_pallas as tp
    rng = np.random.default_rng(nb)
    Ad, Bs = _band(rng, 2, 6, nb, dt, cuda)
    delta = torch.as_tensor([0.0, 1e-3], dtype=dt, device=cuda)
    Ck, Ci, Ek, ok = tp.pallas_tridiag_factor(Ad, Bs, delta)
    Ckr, Cir, Ekr, okr = tp.xla_tridiag_factor_inv(Ad, Bs, delta)
    assert ok.tolist() == okr.tolist() == [True, True]
    for got, want in ((Ck, Ckr), (Ci, Cir), (Ek, Ekr)):
        assert _rel_err(got, want) <= TOL[dt]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, m, B", [(1024, 512, 64), (128, 128, 4),
                                     (96, 67, 3)])
def test_fused_q_per_instance_jc(cuda, dt, n, m, B):
    """K1 with a (B, m, n) Jacobian, each instance its own (the bucketed
    LP campaign's shape), no H (a declared-zero Hessian): within TOL of
    its plain version, launched once.  Scaled so that diag(bnd) is a fifth
    or more of max |Q|; the diagonal is also held on its own, so a kernel
    that drops bnd or reads one instance's for all fails."""
    rng = np.random.default_rng(7 * n + B)

    def t(a):
        return torch.as_tensor(a, dtype=dt, device=cuda)

    Jc = t(rng.normal(size=(B, m, n)) / np.sqrt(n)
           * (rng.random((B, m, n)) < 0.5))
    w = t(rng.uniform(0.1, 10.0, size=(B, m)))
    bnd = t(rng.uniform(0.0, 5.0, size=(B, n)))
    before = ops.launch_counts()["fused_q"]
    got = schur.pallas_fused_q(Jc, w, None, bnd)
    assert ops.launch_counts()["fused_q"] == before + 1
    ref = schur.xla_fused_q(Jc, w, None, bnd)
    assert _rel_err(got, ref) <= TOL[dt]
    assert _rel_err(got.diagonal(dim1=1, dim2=2),
                    ref.diagonal(dim1=1, dim2=2)) <= TOL[dt]


@pytest.mark.gpu
def test_bucket_on_pallas_matches_cpu(cuda):
    """A bucket of four LPs (sized_mixed_suite(96, 48, 2): two feasible,
    two infeasible, each with its own A) solved on the pallas lane on the
    card in float64, K1-K3 launched: the statuses and x (1e-5) of the
    same bucket on the CPU (x of the certified optima)."""
    from onephase_tpu_torch.config import Params
    from onephase_tpu_torch.models.netlib import sized_mixed_suite
    from onephase_tpu_torch.parallel.buckets import solve_bucketed

    probs = sized_mixed_suite(96, 48, n_pairs=2, density=0.5)
    pars = Params().with_overrides({
        "output_level": 0, "term.max_it": 120, "term.tol_opt": 1e-6,
        "kkt.linear_solver_type": "pallas"})
    before = ops.launch_counts()
    on_card = solve_bucketed(probs, pars, round_to=32, dtype=torch.float64,
                             device=cuda)
    after = ops.launch_counts()
    for k in ("fused_q", "chol", "tri_inv_gram"):
        assert after[k] > before[k], k
    on_cpu = solve_bucketed(probs, pars, round_to=32, dtype=torch.float64,
                            device="cpu")
    for name in probs:
        truth = "Optimal" if name.endswith("_feas") else "primal_infeasible"
        assert on_card[name].status == on_cpu[name].status == truth, name
        if truth == "Optimal":
            np.testing.assert_allclose(on_card[name].x, on_cpu[name].x,
                                       rtol=0, atol=1e-5)
