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


def _build_rank(mesh, build_dir):
    """One rank of test_two_ranks_build_one_library: build the kernel
    library into `build_dir` (unless the other rank has) and load it."""
    import ctypes
    from pathlib import Path
    from onephase_tpu_torch.ops import _build
    so = Path(build_dir) / "libonephase_kernels_ranks.so"
    log = _build._build(so, sorted(_build.CSRC.glob("*.cu")), _build._nvcc())
    lib = ctypes.CDLL(str(so))
    return {"built": bool(log), "loaded": hasattr(lib, "op_chol_f64")}


@pytest.mark.gpu
def test_two_ranks_build_one_library(cuda, tmp_path):
    """Two ranks that find no library build it into a fresh directory at
    once: one compiles, the other waits on the lock and loads the same
    file; nothing but the library and its lock is left."""
    from onephase_tpu_torch.parallel.mesh import spawn_ranks
    out = spawn_ranks(_build_rank, 2, "gloo", "cpu", args=(str(tmp_path),),
                      timeout=600.0, store_dir=str(tmp_path))
    assert sorted(o["built"] for o in out) == [False, True]
    assert all(o["loaded"] for o in out)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "libonephase_kernels_ranks.lock", "libonephase_kernels_ranks.so"]



@pytest.mark.gpu
@pytest.mark.parametrize("dt, n, m", [(torch.float32, 256, 128),
                                      (torch.float64, 1024, 512)])
def test_row_sum_depends_on_the_batch_and_the_kernels_do_not(cuda, dt, n,
                                                             m):
    """Why a rank's rows (B/D of them) are held to the same rows solved at
    B/D and not to the whole batch's run: at the float32 bench's and the
    mixed QP's shapes K1, K2 and K3 give rows 0:8 of a B = 16 batch bit for
    bit equal to the same rows run at B = 8 (a block reads one instance),
    but a row sum of a (B, n) tensor (`aten.sum` over dim 1, taken on
    the dense path's first steps) rounds a row differently at B = 8 and B
    = 16: the reduction kernel's layout follows the number of rows
    (tools/roundoff_witness.py --part batch finds it the first operation
    to depart)."""
    g = torch.Generator(device=cuda).manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g, device=cuda, dtype=dt)

    B, rows = 16, 8
    Jc, w = r(m, n), r(B, m).abs() + 0.1
    H, bnd = r(B, n, n), r(B, n).abs() + 1.0
    H = H @ H.mT / n
    Q = schur.pallas_fused_q(Jc, w, H, bnd)
    assert torch.equal(Q[:rows],
                       schur.pallas_fused_q(Jc, w[:rows], H[:rows],
                                            bnd[:rows]))
    L, _, ok = ch.pallas_chol(Q)
    assert bool(ok.all())
    assert torch.equal(L[:rows], ch.pallas_chol(Q[:rows].contiguous())[0])
    assert torch.equal(ch.pallas_tri_inv_gram(L)[:rows],
                       ch.pallas_tri_inv_gram(L[:rows].contiguous()))
    v = r(B, n)
    whole, part = v.sum(1), v[:rows].sum(1)
    assert not torch.equal(whole[:rows], part)
    assert _rel_err(whole[:rows], part) <= TOL[dt]


# ---------------------------------------------------------------------
# matmul modes (ops/precision.py): K1-K3's moded variants against their
# twins in the same mode, max |kernel - twin| / max |twin| <= 1e-4 as in
# IEEE (summation order), and the mode visible in the launch tally
# ---------------------------------------------------------------------
def _mode_ids():
    from onephase_tpu_torch.ops import precision
    return [str(m) for m in precision.CARD_MODES]


@pytest.mark.gpu
@pytest.mark.parametrize("mode_name", _mode_ids())
@pytest.mark.parametrize("n, m, B, shared", [(130, 70, 3, False),
                                             (256, 128, 4, True)])
def test_kernels_in_mode_match_twins(cuda, mode_name, n, m, B, shared):
    from onephase_tpu_torch.ops import precision
    mode = next(x for x in precision.CARD_MODES if str(x) == mode_name)
    Jc, w, H, bnd = _fq_inputs(np.random.default_rng(n + 3 * m), n, m, B,
                               shared, torch.float32, cuda)
    ops.reset_launch_counts()
    # the lower triangle, which the path reads: above it K1 mirrors its
    # rank-m part, whose operands are rounded after the other side's scaling
    Q = schur.pallas_fused_q(Jc, w, H, bnd, mode=mode).tril()
    assert _rel_err(Q, schur.xla_fused_q(Jc, w, H, bnd, mode=mode).tril()) \
        <= 1e-4
    S = _spd(np.random.default_rng(n), B, n, torch.float32, cuda)
    L, d, ok = ch.pallas_chol(S, mode=mode)
    Lt, dt_, okt = ch.blocked_chol(S, mode)
    assert bool(ok.all()) and bool(okt.all())
    assert _rel_err(L, Lt) <= 1e-4 and _rel_err(d, dt_) <= 1e-4
    M = ch.pallas_tri_inv_gram(Lt, mode=mode)
    assert torch.equal(M, M.mT)
    assert _rel_err(M, ch.xla_chol_inv_from_L(Lt, mode)) <= 1e-4
    assert ops.launch_modes() == {k: {mode_name: 1} for k in
                                  ("fused_q", "chol", "tri_inv_gram")}


@pytest.mark.gpu
@pytest.mark.parametrize("mode_name", _mode_ids())
def test_fused_q_rank_one_in_mode_is_its_twin(cuda, mode_name):
    """With one constraint row each entry is one product: the kernel adds
    the mode's part products to +0 in the twin's order (smallest first), so
    kernel and twin agree bit for bit, in both of K1's modes."""
    from onephase_tpu_torch.ops import precision
    mode = next(x for x in precision.CARD_MODES if str(x) == mode_name)
    Jc, w, H, bnd = _fq_inputs(np.random.default_rng(1), 96, 1, 2, True,
                               torch.float32, cuda)
    Q = schur.pallas_fused_q(Jc, w, H, bnd, mode=mode)
    assert torch.equal(Q.tril(),
                       schur.xla_fused_q(Jc, w, H, bnd, mode=mode).tril())
    if mode.passes <= 3:
        # (the 6- and 9-product sets come within an ulp of the IEEE
        # product, and may round to it)
        assert not torch.equal(Q.tril(), schur.pallas_fused_q(
            Jc, w, H, bnd).tril())
    # the Gram mode: Li with one nonzero row (its last)
    Li = torch.zeros(2, 96, 96, device=cuda)
    Li[:, -1] = torch.as_tensor(np.random.default_rng(2).normal(size=(2, 96)),
                                dtype=torch.float32, device=cuda)
    G = torch.empty_like(Li)
    schur.launch_fused_q(Li, None, None, None, G, lower=True, mode=mode)
    assert torch.equal(G.tril(),
                       precision.matmul(Li.mT, Li, mode).tril())


@pytest.mark.gpu
@pytest.mark.parametrize("mode_name", _mode_ids())
def test_chol_tri_inv_one_product_in_mode_is_its_twin(cuda, mode_name):
    """On chip_smoke.py's one-product operands (one product an entry of the
    output, taken in a trailing or block update from +0) K2 and K3's
    inverse equal their twins bit for bit in every mode, and differ from
    the IEEE kernels where the mode takes at most 3 products."""
    import importlib.util
    from pathlib import Path
    from onephase_tpu_torch.ops import precision
    mode = next(x for x in precision.CARD_MODES if str(x) == mode_name)
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    Q, L = smoke.one_product_operands(3, 256, 7, cuda)
    Lk = ch.pallas_chol(Q, mode=mode)[0]
    assert torch.equal(Lk, ch.blocked_chol(Q, mode)[0])
    X = torch.empty_like(L)
    ch.launch_tri_inv(L, X, mode)
    assert torch.equal(X, ch.blocked_tri_inv(L, mode=mode))
    if mode.passes <= 3:
        Xi = torch.empty_like(L)
        ch.launch_tri_inv(L, Xi, precision.IEEE)
        assert not torch.equal(Lk, ch.pallas_chol(Q, mode=precision.IEEE)[0])
        assert not torch.equal(X, Xi)


def _misaligned(t):
    """A contiguous copy of `t` whose base lies 4 bytes off a 16-byte
    boundary (the kernels' element-copy and scalar-store routes)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("mode_name", _mode_ids())
@pytest.mark.parametrize("n, m, B, shared, h, aligned", [
    (130, 70, 2, True, True, True), (130, 70, 1, False, False, True),
    (77, 0, 2, True, True, True), (77, 1, 3, False, False, True),
    (128, 33, 2, False, True, False), (200, 130, 1, True, False, False)])
def test_fused_q_tensor_cores_at_the_edges(cuda, mode_name, n, m, B, shared,
                                           h, aligned):
    """K1's tensor-core instantiations and its `lower` mode at n and m off
    the 8, 16 and 128 grids, m = 0 and 1, B = 1, shared and per-instance Jc,
    H and H = None, aligned and 4-byte-offset operands: the lower triangle
    within 1e-4 of the twin, the Gram product's within 1e-4 of its twin
    and bit-symmetric."""
    from onephase_tpu_torch.ops import precision
    mode = next(x for x in precision.CARD_MODES if str(x) == mode_name)
    Jc, w, H, bnd = _fq_inputs(np.random.default_rng(n + 7 * m + B), n, m,
                               B, shared, torch.float32, cuda)
    H = H if h else None
    if not aligned:
        Jc = _misaligned(Jc)
        H = None if H is None else _misaligned(H)
    ops.reset_launch_counts()
    Q = schur.pallas_fused_q(Jc, w, H, bnd, mode=mode)
    assert ops.launch_modes() == {"fused_q": {mode_name: 1}}
    assert _rel_err(Q.tril(), schur.xla_fused_q(Jc, w, H, bnd,
                                                mode=mode).tril()) <= 1e-4
    if H is None:
        # the rank-m part above the diagonal mirrors the entry below it
        R = Q - torch.diag_embed(bnd)
        assert torch.equal(R, R.mT)
    S = _spd(np.random.default_rng(n), B, n, torch.float32, cuda)
    L = ch.pallas_chol(S, mode=precision.IEEE)[0]
    Li = torch.empty_like(L)
    ch.launch_tri_inv(L, Li)
    G = torch.empty_like(Li)
    schur.launch_fused_q(Li, None, None, None, G, lower=True, mode=mode)
    assert torch.equal(G, G.mT)
    assert _rel_err(G.tril(), precision.matmul(Li.mT, Li, mode).tril()) \
        <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("mode_name", _mode_ids())
@pytest.mark.parametrize("B, n", [(2, 1), (2, 33), (2, 65), (3, 130),
                                  (2, 1024), (256, 64), (64, 16), (64, 1),
                                  (1, 1)])
def test_chol_tensor_cores_in_mode(cuda, mode_name, B, n):
    """K2's moded instantiation (the trailing update on the tensor cores,
    the panel's rows and products from parts split once) against its twin
    at n 1 to 1024 across the 32- and 64-column panels and at the scenario
    shapes: L and d within chip_smoke.py's PREC_TOL (1e-4, one-pass bf16
    5e-4), every pivot accepted, the launch tallied under the mode."""
    from onephase_tpu_torch.ops import precision
    mode = next(x for x in precision.CARD_MODES if str(x) == mode_name)
    smoke = _smoke()
    tol = smoke.PREC_TOL.get(mode_name, smoke.PREC_TOL_DEFAULT)
    S = _spd(np.random.default_rng(B + n), B, n, torch.float32, cuda)
    ops.reset_launch_counts()
    L, d, ok = ch.pallas_chol(S, mode=mode)
    assert ops.launch_modes() == {"chol": {mode_name: 1}}
    Lt, dt_, okt = ch.blocked_chol(S, mode)
    assert bool(ok.all()) and bool(okt.all())
    assert torch.equal(L, L.tril())
    assert _rel_err(L, Lt) <= tol and _rel_err(d, dt_) <= tol


def _smoke():
    """chip_smoke.py, loaded as a module (its one-product operands)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.gpu
@pytest.mark.parametrize("mode_name", _mode_ids())
@pytest.mark.parametrize("K, nb", [(40, 32), (20, 63), (7, 30), (6, 5),
                                   (1, 32), (1, 63), (9, 64)])
def test_tridiag_in_mode_matches_twins(cuda, mode_name, K, nb):
    """K7 and K5 in each mode against their twins in the same mode
    (chip_smoke.py's `_tridiag_tol`: 8 unit roundoffs of the mode's input
    type in a one-pass mode, 1e-4 in a split mode), K7 within 1e-5 of its
    mode's recurrences on its own output, with the launches tallied under
    the mode; on chip_smoke.py's one-product operands bit for bit their
    twins, and off the IEEE kernels where the mode takes at most 3
    products."""
    from onephase_tpu_torch.ops import precision
    from onephase_tpu_torch.ops import tridiag_pallas as tp
    mode = next(x for x in precision.CARD_MODES if str(x) == mode_name)
    smoke = _smoke()
    tol = smoke._tridiag_tol(mode)
    rng = np.random.default_rng(K + nb)
    Ad, Bs = _band(rng, 2, K, nb, torch.float32, cuda)
    b = torch.as_tensor(rng.normal(size=(2, K, nb)), dtype=torch.float32,
                        device=cuda)
    ops.reset_launch_counts()
    got = tp.pallas_tridiag_factor(Ad, Bs, 1e-4, mode=mode)
    twin = tp.xla_tridiag_factor_inv(Ad, Bs, 1e-4, mode=mode)
    assert bool(got[3].all()) and bool(twin[3].all())
    for g, t in zip(got[:3], twin[:3]):
        assert g.numel() == 0 or _rel_err(g, t) <= tol   # Ek: K = 1
    delta = torch.full((2,), 1e-4, device=cuda)
    assert smoke._tridiag_factor_residual(*got[:3], Ad, Bs, delta,
                                          mode) <= 1e-5
    x = tp.pallas_tridiag_solve(twin[1], twin[2], b, mode=mode)
    assert _rel_err(x, tp.xla_tridiag_solve_inv(twin[1], twin[2], b,
                                                mode=mode)) <= tol
    assert ops.launch_modes() == {"tridiag_factor": {mode_name: 1},
                                  "tridiag_solve": {mode_name: 1}}
    (Ad, Bs, delta), (Ci, Ek, b) = smoke.tridiag_one_product_operands(
        K, nb, 3, cuda)
    got = tp.pallas_tridiag_factor(Ad, Bs, delta, mode=mode)
    twin = tp.xla_tridiag_factor_inv(Ad, Bs, delta, mode=mode)
    assert all(torch.equal(g, t) for g, t in zip(got, twin))
    x = tp.pallas_tridiag_solve(Ci, Ek, b, mode=mode)
    assert torch.equal(x, tp.xla_tridiag_solve_inv(Ci, Ek, b, mode=mode))
    if mode.passes <= 3:
        ieee = tp.pallas_tridiag_factor(Ad, Bs, delta, mode=precision.IEEE)
        assert any(not torch.equal(g, i) for g, i in zip(got[:3], ieee[:3]))
        assert not torch.equal(x, tp.pallas_tridiag_solve(
            Ci, Ek, b, mode=precision.IEEE))


@pytest.mark.gpu
@pytest.mark.parametrize("mode_name", ["ieee", "tf32", "bf16_x9"])
@pytest.mark.parametrize("K, nb", [(9, 32), (5, 63)])
def test_tridiag_phases_on_the_card(cuda, mode_name, K, nb):
    """The clocked copies of K7 and K5 (`tridiag_phases`) run in IEEE and in
    the modes: every phase's share in [0, 1], the shares summing to 1, a
    positive cycle count; refused on float64."""
    from onephase_tpu_torch.ops import precision
    from onephase_tpu_torch.ops import tridiag_pallas as tp
    mode = next((x for x in precision.CARD_MODES if str(x) == mode_name),
                precision.IEEE)
    rng = np.random.default_rng(K + nb)
    Ad, Bs = _band(rng, 2, K, nb, torch.float32, cuda)
    b = torch.as_tensor(rng.normal(size=(2, K, nb)), dtype=torch.float32,
                        device=cuda)
    out = tp.tridiag_phases(Ad, Bs, 1e-4, b, mode)
    for kernel, names in tp.TRIDIAG_PHASES.items():
        share = out[kernel]["share"]
        assert list(share) == list(names)
        assert all(0.0 <= v <= 1.0 for v in share.values())
        assert abs(sum(share.values()) - 1.0) < 1e-6
        assert out[kernel]["cycles"] > 0
    with pytest.raises(ValueError):
        tp.tridiag_phases(Ad.double(), Bs.double(), 1e-4, b.double())


@pytest.mark.gpu
def test_modes_refused_where_not_built(cuda):
    """A mode code no kernel has raises (nothing falls back to IEEE), in K2,
    K7 and K5; under a non-IEEE mode K7 and K5 run in it on float32
    operands (their launches tallied under it) and the chain kernel's
    pallas lane takes it; float64 operands run IEEE under any mode."""
    from onephase_tpu_torch.config import Params
    from onephase_tpu_torch.models.examples import chain_ocp
    from onephase_tpu_torch.ops import precision
    from onephase_tpu_torch.ops import tridiag_pallas as tp
    from onephase_tpu_torch.parallel.chain import ChainKernel
    bad = precision.Mode("f16", 3)
    S = _spd(np.random.default_rng(0), 2, 64, torch.float32, cuda)
    with pytest.raises(RuntimeError):
        ch.pallas_chol(S, mode=bad)
    D = _spd(np.random.default_rng(1), 1, 8, torch.float32, cuda)
    Ad = D[:, None].expand(1, 3, 8, 8).contiguous()
    Bs = torch.zeros(1, 2, 8, 8, device=cuda)
    b = torch.ones(1, 3, 8, device=cuda)
    with pytest.raises(RuntimeError):
        tp.pallas_tridiag_factor(Ad, Bs, 0.0, mode=bad)
    _, Ci, Ek, _ = tp.pallas_tridiag_factor(Ad, Bs, 0.0)
    with pytest.raises(RuntimeError):
        tp.pallas_tridiag_solve(Ci, Ek, b, mode=bad)
    ops.reset_launch_counts()
    with precision.scope("BF16_BF16_F32", "cuda"):
        tp.pallas_tridiag_factor(Ad, Bs, 0.0)
        tp.pallas_tridiag_solve(Ci, Ek, b)
        L64, _, _ = ch.pallas_chol(S.double())
        x64 = tp.pallas_tridiag_solve(Ci.double(), Ek.double(), b.double())
    assert ops.launch_modes() == {"tridiag_factor": {"bf16": 1},
                                  "tridiag_solve": {"bf16": 1, "ieee": 1},
                                  "chol": {"ieee": 1}}
    assert torch.equal(L64, ch.pallas_chol(S.double())[0])
    assert torch.equal(x64, tp.pallas_tridiag_solve(
        Ci.double(), Ek.double(), b.double()))
    pars = Params().with_overrides({"kkt.linear_solver_type": "pallas",
                                    "matmul_precision": "BF16_BF16_F32"})
    ChainKernel(chain_ocp(K=4, nx=2, mc=1, device=cuda), pars,
                dtype=torch.float32, device=cuda)


# ---------------------------------------------------------------------
# K1 in float64 on the FP64 tensor cores (fused_q_dmma_kernel, mma.sync
# m16n8k8 f64): n off the 64 and 128 tiles and n = 2048, m = 0 and m off
# the mma's depth of 8, shared and per-instance Jc, H = None, w over
# 1e-8 .. 1e8, the 64- and the 128-edge grids, one-element copies (odd n)
# ---------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("n, m, B, shared, h, spread", [
    (130, 70, 3, True, True, False), (200, 37, 2, False, True, False),
    (2048, 1024, 16, True, True, False), (1030, 70, 16, True, False, True),
    (256, 0, 16, True, True, False), (77, 13, 1, False, False, True),
    (255, 9, 96, False, True, False), (1024, 517, 64, True, True, True)])
def test_fused_q_float64_dmma_edges(cuda, n, m, B, shared, h, spread):
    """K1 within 1e-10 of its plain version, its rank-m part bit-symmetric,
    K6's full Q equal to K1's bit for bit, one launch tallied."""
    dt = torch.float64
    Jc, w, H, bnd = _fq_inputs(np.random.default_rng(n + 5 * m + B), n, m,
                               B, shared, dt, cuda)
    H = H if h else None
    if spread:
        w = torch.as_tensor(10.0 ** np.random.default_rng(m).uniform(
            -8.0, 8.0, size=(B, m)), dtype=dt, device=cuda)
    ops.reset_launch_counts()
    Q = schur.pallas_fused_q(Jc, w, H, bnd)
    assert ops.launch_modes() == {"fused_q": {"ieee": 1}}
    assert _rel_err(Q, schur.xla_fused_q(Jc, w, H, bnd)) <= TOL[dt]
    R = schur.pallas_fused_q(Jc, w, None, torch.zeros_like(bnd))
    assert torch.equal(R, R.mT)
    assert torch.equal(Q, schur.pallas_fused_q_tri(Jc, w, H, bnd))


@pytest.mark.gpu
@pytest.mark.parametrize("n, B", [(65, 3), (130, 3), (1030, 16), (256, 16)])
def test_fused_q_float64_lower_mode_on_an_inverse(cuda, n, B):
    """K1's `lower` mode in float64 (K3's Gram half) on an L^-1: M = Li^T
    Li within 1e-10 of the plain product, bit-symmetric, and K3's M."""
    dt = torch.float64
    L = ch.pallas_chol(_spd(np.random.default_rng(n), B, n, dt, cuda))[0]
    Li = torch.empty_like(L)
    ch.launch_tri_inv(L, Li)
    G = torch.empty_like(Li)
    schur.launch_fused_q(Li, None, None, None, G, lower=True)
    assert torch.equal(G, G.mT)
    assert _rel_err(G, Li.mT @ Li) <= TOL[dt]
    assert torch.equal(G, ch.pallas_tri_inv_gram(L))


# ---------------------------------------------------------------------
# K3's inverse in the matmul modes (csrc/tri_inv_mode.cuh): the update on
# the tensor cores, the substitution split once
# ---------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("mode_name", _mode_ids())
@pytest.mark.parametrize("n", [1, 31, 33, 63, 65, 130])
def test_tri_inv_in_mode_at_the_chunk_edges(cuda, mode_name, n):
    """The moded inverse at n on both sides of its 32-row chunks and
    64-column tiles: lower triangular, within chip_smoke.py's PREC_TOL of
    its twin (the same 32-row recurrence), and as close to its mode's
    recurrence as the IEEE kernel is to IEEE's (float32 sums: at most 4x,
    or 1e-7); the whole of K3 tallied under the mode."""
    from onephase_tpu_torch.ops import precision
    mode = next(x for x in precision.CARD_MODES if str(x) == mode_name)
    smoke = _smoke()
    tol = smoke.PREC_TOL.get(mode_name, smoke.PREC_TOL_DEFAULT)
    B = 3
    L = ch.pallas_chol(_spd(np.random.default_rng(n + 1), B, n,
                            torch.float32, cuda), mode=precision.IEEE)[0]
    X, Xi = torch.empty_like(L), torch.empty_like(L)
    ch.launch_tri_inv(L, X, mode)
    ch.launch_tri_inv(L, Xi, precision.IEEE)
    assert bool(torch.isfinite(X).all())
    assert torch.equal(X, X.tril())
    assert _rel_err(X, ch.blocked_tri_inv(L, mode=mode)) <= tol
    assert smoke.inverse_residual(L, X, mode) <= max(
        4.0 * smoke.inverse_residual(L, Xi, precision.IEEE), 1e-7)
    ops.reset_launch_counts()
    M = ch.pallas_tri_inv_gram(L, mode=mode)
    assert ops.launch_modes() == {"tri_inv_gram": {mode_name: 1}}
    assert torch.equal(M, M.mT)


@pytest.mark.gpu
def test_mode_codes_through_the_library(cuda):
    """Through the built library: K3's float32 inverse launches code 0
    (IEEE) and every card mode's code and refuses every other code of the
    kinds 0-3 and pass counts 0-15 (nothing runs as IEEE in its place);
    K3's float64 inverse and K1's float64 route take code 0 alone."""
    from onephase_tpu_torch.ops import _build, precision
    card = {m.code for m in precision.CARD_MODES}
    L = ch.pallas_chol(_spd(np.random.default_rng(5), 2, 40, torch.float32,
                            cuda))[0]

    def inverse(L, code):
        X = torch.empty_like(L)
        with torch.cuda.device(cuda):
            return _build.entry("op_tri_inv", L.dtype)(
                L.data_ptr(), X.data_ptr(), L.shape[0], L.shape[-1], code,
                _build.stream_ptr(L))

    for code in range(0x40):
        assert (inverse(L, code) == 0) == (code == 0 or code in card), \
            hex(code)
    assert inverse(L.double(), 0) == 0
    assert all(inverse(L.double(), code) != 0 for code in card)
    Jc, w, H, bnd = _fq_inputs(np.random.default_rng(6), 40, 8, 2, True,
                               torch.float64, cuda)
    Q = torch.empty(2, 40, 40, dtype=torch.float64, device=cuda)

    def fused_q(code):   # Jc and H shared: batch strides 0
        with torch.cuda.device(cuda):
            return _build.entry("op_fused_q", torch.float64)(
                Jc.data_ptr(), 0, w.data_ptr(), H.data_ptr(), 0,
                bnd.data_ptr(), Q.data_ptr(), 2, 8, 40, 0, code,
                _build.stream_ptr(Q))

    assert fused_q(0) == 0
    assert all(fused_q(code) != 0 for code in card)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("mode_name", ["ieee", "tf32", "bf16_x9", "f16"])
@pytest.mark.parametrize("n, B", [(130, 3), (256, 4)])
def test_tri_inv_phases_on_the_card(cuda, mode_name, n, B):
    """The clocked copy of K3's inverse (`tri_inv_phases`) runs in IEEE
    and in the modes: every share in [0, 1], the shares summing to 1, a
    positive cycle count, no share for a phase the kernel lacks; refused
    on float64."""
    from onephase_tpu_torch.ops import precision
    mode = next((x for x in precision.CARD_MODES if str(x) == mode_name),
                precision.IEEE)
    L = ch.pallas_chol(_spd(np.random.default_rng(n), B, n, torch.float32,
                            cuda), mode=precision.IEEE)[0]
    out = ch.tri_inv_phases(L, mode)
    share = out["share"]
    assert list(share) == list(ch.TRI_INV_PHASES)
    assert all(0.0 <= v <= 1.0 for v in share.values())
    assert abs(sum(share.values()) - 1.0) < 1e-6
    assert out["cycles"] > 0
    assert share["update"] > 0 and share["solve"] > 0
    with pytest.raises(ValueError):
        ch.tri_inv_phases(L.double())


# ---------------------------------------------------------------------
# K2 in float64 (its trailing update on the FP64 tensor cores), the split
# modes' panel on the tensor cores, at the panel and tile edges; the lean
# launch path's errors
_F64_EDGES = [(B, n) for n in (1, 33, 64, 65, 127, 129, 130, 1024)
              for B in (1, 2, 3)] + [(256, 64), (64, 16), (64, 1), (1, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("B, n", _F64_EDGES)
def test_chol_float64_at_the_edges(cuda, B, n):
    """K2 in float64 against cholesky_ex: L and d within 1e-12 of it
    (relative to the largest entry; summation order alone), ok equal, L
    lower triangular, ok a bool."""
    Q = _spd(np.random.default_rng(3 * n + B), B, n, torch.float64, cuda)
    L, d, ok = ch.pallas_chol(Q)
    Lr, info = torch.linalg.cholesky_ex(Q)
    assert ok.dtype == torch.bool
    assert ok.tolist() == (info == 0).tolist() == [True] * B
    assert torch.equal(L, L.tril())
    assert _rel_err(L, Lr) <= 1e-12
    assert _rel_err(d, torch.diagonal(Lr, dim1=-2, dim2=-1)) <= 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("n", [33, 65, 130, 1024])
def test_chol_float64_flags_the_non_pd_instance_alone(cuda, n):
    """A non-PD instance between two SPD ones: ok False there alone, as
    cholesky_ex's info says, and the SPD instances' factors unchanged."""
    Q = _spd(np.random.default_rng(n), 3, n, torch.float64, cuda)
    Q[1] -= 2e3 * n * torch.eye(n, dtype=torch.float64, device=cuda)
    L, d, ok = ch.pallas_chol(Q)
    _, info = torch.linalg.cholesky_ex(Q)
    assert ok.tolist() == (info == 0).tolist() == [True, False, True]
    Lr = torch.linalg.cholesky_ex(Q[::2])[0]
    assert _rel_err(L[::2], Lr) <= 1e-12


def _split_modes():
    from onephase_tpu_torch.ops import precision
    return [str(m) for m in precision.CARD_MODES if m.passes > 1]


@pytest.mark.gpu
@pytest.mark.parametrize("mode_name", _split_modes())
@pytest.mark.parametrize("B, n", [(2, 1), (1, 33), (3, 64), (2, 65),
                                  (1, 127), (3, 129), (1, 130), (3, 1024),
                                  (256, 64), (64, 16), (64, 1), (1, 1)])
def test_chol_split_modes_at_the_edges(cuda, mode_name, B, n):
    """The split modes' panel on the tensor cores (16-row warp blocks,
    sub-blocks of the mma depth) across the inner and outer panel edges,
    a ragged last chunk of rows and the scenario's shapes: L and d within
    chip_smoke.py's PREC_TOL of blocked_chol, every pivot accepted, L lower
    triangular."""
    from onephase_tpu_torch.ops import precision
    mode = next(x for x in precision.CARD_MODES if str(x) == mode_name)
    tol = _smoke().PREC_TOL.get(mode_name, _smoke().PREC_TOL_DEFAULT)
    S = _spd(np.random.default_rng(5 * n + B), B, n, torch.float32, cuda)
    L, d, ok = ch.pallas_chol(S, mode=mode)
    Lt, dt_, okt = ch.blocked_chol(S, mode)
    assert bool(ok.all()) and bool(okt.all())
    assert torch.equal(L, L.tril())
    assert _rel_err(L, Lt) <= tol and _rel_err(d, dt_) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_lean_wrappers_raise_as_before(cuda, dt):
    """K1's and K2's wrappers on the card refuse a wrong dtype, shape,
    device or layout with the errors of their detailed checks, and launch
    nothing."""
    Jc, w, H, bnd = _fq_inputs(np.random.default_rng(8), 40, 8, 2, True, dt,
                               cuda)
    other = torch.float32 if dt == torch.float64 else torch.float64
    ops.reset_launch_counts()
    bad = [
        ((Jc, w.to(other), H, bnd), "w is"),
        ((Jc, w.cpu(), H, bnd), "w is"),
        ((Jc[:, :-1].contiguous(), w, H, bnd), "Jc has shape"),
        ((Jc, w, torch.empty(80, 40, dtype=dt, device=cuda)[::2], bnd),
         "H must be contiguous"),
    ]
    for args, msg in bad:
        with pytest.raises(ValueError, match=msg):
            schur.pallas_fused_q(*args)
    with pytest.raises(TypeError):
        schur.pallas_fused_q(Jc.int(), w.int(), None, bnd.int())
    Q = _spd(np.random.default_rng(9), 2, 40, dt, cuda)
    with pytest.raises(ValueError, match="must be contiguous"):
        ch.pallas_chol(Q.mT)
    with pytest.raises(ValueError, match="expected a"):
        ch.pallas_chol(Q[0])
    with pytest.raises(TypeError):
        ch.pallas_chol(Q.half())
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHES, 0)
