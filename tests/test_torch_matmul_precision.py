"""`Params.matmul_precision` in the port (ops/precision.py).

(a) Every value of JAX's `jax_default_matmul_precision` enum, plus None and
    "", through the JAX package's `one_phase_solve` on zoo.circle1 in
    float64 on the CPU and through the port's `make_kernel` and
    `one_phase_solve`: both run or both raise.  Where both run, status and
    iterations are equal and x agrees to 1e-6 relative to max(1, |x|)
    (tests/test_torch_zoo_nlps.py's parity tolerance), and the port's x is
    its own "highest" run's bit for bit (the knob is a no-op on the CPU).
(b) `resolve(name, "cuda")`, a pure function, gives the mode table.
(c) The plain twins in every mode the kernels take on the card, on seeded
    numpy inputs, against a numpy model of the mode: each operand rounded
    (and split) by an independent float64 model of the rounding, the part
    products accumulated in float64 and rounded once.  The model's
    rounding is held bit for bit to `round_to` on a table of edge values
    (ties, subnormals, overflow, +-inf, NaN, signed zero).  Tolerance: the
    twins' float32 summation, 1e-5 of the sum of the magnitudes of an
    entry's terms at these sizes (<= 48 terms: under 48 float32 ulps); the
    factorizations are held by their recurrences on the twin's own factor
    (the rounding of an operand is decided by the twin's value, which an
    independent float64 factor could round to the other side).
(d) The twins of K7 and K5 (ops/tridiag_pallas.py) in the same modes, the
    same way: K7's on its recurrences (E E^T, the block Cholesky, its
    inverse, B_k Ci_k^T) over its own entries, K5's against a float64
    run of its two sweeps, the vectors carried in float32 as the twin
    carries them; the IEEE route is the plain one bit for bit; and
    chip_smoke.py's one-product operands take at most one product of two
    nonzero entries an entry, so that on the card kernel and twin agree
    bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import onephase_tpu
import onephase_tpu_torch
from onephase_tpu.config import Params as JParams
from onephase_tpu_torch.config import Params
from onephase_tpu_torch.ipm.dual import make_kernel
from onephase_tpu_torch.ops import block_tridiag as tbt
from onephase_tpu_torch.ops import cholesky as ch
from onephase_tpu_torch.ops import precision as prec
from onephase_tpu_torch.ops import schur
from onephase_tpu_torch.ops import tridiag_pallas as ttp

from test_torch_twins import jax_solve, zoo_pair
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OPTS = {"term!max_it": 81, "output_level": 0}
VALUES = (None, "") + prec.JAX_ENUM
TOL = 1e-5


def _port_solve(value):
    from onephase_tpu_torch.nlp import canonicalize
    _, tspec = zoo_pair("circle1")
    nlp = canonicalize(tspec, dtype=torch.float64, device="cpu")
    opts = dict(OPTS, matmul_precision=value)
    make_kernel(nlp, Params().with_overrides(opts))
    return onephase_tpu_torch.one_phase_solve(nlp, options=opts)


def _outcome(fn):
    try:
        return fn(), None
    except Exception as e:   # noqa: BLE001 -- either package's refusal
        return None, e


@pytest.mark.parametrize("value", VALUES, ids=repr)
def test_runs_or_raises_as_the_jax_package(value):
    jspec, _ = zoo_pair("circle1")
    rj, ej = _outcome(lambda: jax_solve(jspec, dict(
        OPTS, matmul_precision=value)))
    rt, et = _outcome(lambda: _port_solve(value))
    assert (ej is None) == (et is None), (value, ej, et)
    if ej is not None:
        return
    assert (rt.status, rt.iterations) == (rj.status, rj.iterations)
    scale = np.maximum(1.0, np.abs(rj.x))
    np.testing.assert_array_less(np.abs(rt.x - rj.x) / scale, 1e-6)
    highest = _port_solve("highest")
    assert np.array_equal(rt.x, highest.x)
    assert rt.iterations == highest.iterations


def test_none_through_params_runs_in_both():
    """None set on the Params object (options refuse a non-string in both
    packages): both run, as "default"."""
    jspec, tspec = zoo_pair("circle1")
    from onephase_tpu import nlp as jnlp
    from onephase_tpu_torch.nlp import canonicalize
    jp = dataclasses.replace(JParams().with_overrides(OPTS),
                             matmul_precision=None)
    tp = dataclasses.replace(Params().with_overrides(OPTS),
                             matmul_precision=None)
    import jax.numpy as jnp
    rj = onephase_tpu.one_phase_solve(jnlp.canonicalize(
        jspec, dtype=jnp.float64), jp)
    rt = onephase_tpu_torch.one_phase_solve(canonicalize(
        tspec, dtype=torch.float64, device="cpu"), tp)
    assert (rt.status, rt.iterations) == (rj.status, rj.iterations)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# (b) the table on a card
# ----------------------------------------------------------------------
M = prec.Mode
CUDA_TABLE = {
    None: M("tf32"), "": M("tf32"), "default": M("tf32"),
    "bfloat16": M("tf32"), "high": M("tf32"), "tensorfloat32": M("tf32"),
    "highest": M(), "float32": M(), "F32_F32_F32": M(),
    "TF32_TF32_F32": M("tf32"), "TF32_TF32_F32_X3": M("tf32", 3),
    "BF16_BF16_F32": M("bf16"), "BF16_BF16_F32_X3": M("bf16", 3),
    "BF16_BF16_F32_X6": M("bf16", 6), "BF16_BF16_F32_X9": M("bf16", 9),
    "F16_F16_F32": M("f16"),
}
CPU_RUNS = {None, "", "default", "bfloat16", "high", "tensorfloat32",
            "highest", "float32", "F32_F32_F32"}


@pytest.mark.parametrize("value", VALUES + ("fastest", "bfloat16_3x", "x"),
                         ids=repr)
def test_resolve_table(value):
    if value in CUDA_TABLE:
        assert prec.resolve(value, "cuda") == CUDA_TABLE[value]
    else:
        with pytest.raises(ValueError, match=repr(value)):
            prec.resolve(value, "cuda")
    if value in CPU_RUNS:
        assert prec.resolve(value, "cpu") == prec.IEEE
    else:
        with pytest.raises(ValueError):
            prec.resolve(value, "cpu")


def test_mode_pairs():
    """The part products of each pass count, smallest first."""
    assert M("bf16", 1).pairs == ((0, 0),)
    assert M("bf16", 3).pairs == ((1, 0), (0, 1), (0, 0))
    assert M("bf16", 6).pairs == ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1),
                                  (0, 0))
    assert len(M("bf16", 9).pairs) == 9 and M("tf32", 3).parts == 2
    assert {m.code for m in prec.CARD_MODES} == {17, 19, 33, 35, 38, 41, 49}


# ----------------------------------------------------------------------
# (c) the twins against a numpy model of each mode
# ----------------------------------------------------------------------
_FMT = {   # significand bits, exponent of the smallest quantum, max finite
    "tf32": (11, -136, (2 - 2.0 ** -10) * 2.0 ** 127),
    "bf16": (8, -133, (2 - 2.0 ** -7) * 2.0 ** 127),
    "f16": (11, -24, 65504.0),
}


def np_round(x32, kind):
    """float32 values rounded to `kind` (float64 result): the quantum of
    the value's binade (or the format's smallest), ties away from zero for
    tf32 and to even for bf16 and fp16; overflow to inf; inf, NaN and
    signed zeros kept."""
    x = np.asarray(x32, np.float32).astype(np.float64)
    if kind == "none":
        return x
    bits, qmin, big = _FMT[kind]
    with np.errstate(all="ignore"):
        e = np.frexp(x)[1]
        q = np.ldexp(1.0, np.maximum(e - bits, qmin))
        y = np.abs(x) / q
        r = np.floor(y + 0.5) if kind == "tf32" else np.rint(y)
        out = np.sign(x) * r * q
        out = np.where(np.abs(out) > big, np.sign(x) * np.inf, out)
    return np.where(np.isfinite(x) & (x != 0), out, x)


def np_parts(x32, mode):
    parts, rest = [], np.asarray(x32, np.float32).astype(np.float64)
    for _ in range(mode.parts):
        p = np_round(rest.astype(np.float32), mode.kind)
        parts.append(p)
        rest = rest - p
    return parts


def np_prod(a32, b32, mode, contract):
    """The mode's product of `a32` and `b32` in float64 (exact part
    products, summed by `contract`), and the sum of the terms'
    magnitudes."""
    pa, pb = np_parts(a32, mode), np_parts(b32, mode)
    val = sum(contract(pa[i], pb[j]) for i, j in mode.pairs)
    mag = contract(np.abs(np.asarray(a32, np.float64)),
                   np.abs(np.asarray(b32, np.float64)))
    return val, mag


EDGES = np.array([
    0.0, -0.0, 1.0, -1.0, 1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11,
    -(1 + 2.0 ** -11), 1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8,
    1 + 2.0 ** -8 + 2.0 ** -23, 2.0 ** -149, 3 * 2.0 ** -149,
    2.0 ** -130 + 2.0 ** -140, 3 * 2.0 ** -137, 2.0 ** -126, 2.0 ** -133,
    3 * 2.0 ** -134, 3.4028234663852886e38, 3.3e38, 65504.0, 65519.0,
    65520.0, 2.0 ** -24, 2.0 ** -25, 3 * 2.0 ** -26, 1e-30, np.inf,
    -np.inf, np.nan], np.float32)


@pytest.mark.parametrize("kind", ["tf32", "bf16", "f16"])
def test_rounding_matches_model_on_edges(kind):
    rng = np.random.default_rng(3)
    x = np.concatenate([EDGES, (rng.normal(size=2000)
                                * 10.0 ** rng.uniform(-40, 38, 2000))
                        .astype(np.float32)])
    got = prec.round_to(torch.from_numpy(x), kind).numpy()
    want = np_round(x, kind).astype(np.float32)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.array_equal(got[ok].view(np.uint32), want[ok].view(np.uint32))


@pytest.mark.parametrize("mode", prec.CARD_MODES, ids=str)
def test_split_parts_are_exact_in_the_mma_type(mode):
    """The premise of the tensor-core kernels (csrc/mm_tc.cuh): every part
    `precision.split` gives is exact in the mma's operand type (a bf16 or
    fp16 part survives the round trip through torch.bfloat16 / float16, a
    TF32 part has the 13 bits below its fraction zero), so a part product
    is exact; and the parts sum back to x within the rounding of the last
    part (half its quantum, or of the type's smallest quantum where it
    underflows).  On random, subnormal and large float32 entries within the
    type's finite range."""
    bits, qmin, big = _FMT[mode.kind]
    rng = np.random.default_rng(mode.code)
    x = np.concatenate([
        rng.normal(size=4000) * 10.0 ** rng.uniform(-3, 3, 4000),
        rng.uniform(-1, 1, 1000) * 2.0 ** -126,            # f32 subnormal
        rng.uniform(-1, 1, 1000) * 2.0 ** (qmin + bits),   # the type's
        rng.uniform(0.5, 0.99, 1000) * big * rng.choice([-1, 1], 1000),
        EDGES[np.isfinite(EDGES) & (np.abs(EDGES) <= big)]]).astype(
            np.float32)
    xt = torch.from_numpy(x)
    parts = prec.split(xt, mode)
    assert len(parts) == mode.parts
    for p in parts:
        assert p.dtype == torch.float32 and bool(torch.isfinite(p).all())
        if mode.kind == "tf32":
            assert not bool((p.view(torch.int32) & 0x1FFF).any())
        else:
            dt = torch.bfloat16 if mode.kind == "bf16" else torch.float16
            assert torch.equal(p.to(dt).float(), p)
    total = sum(p.double() for p in parts)
    last = parts[-1].double().abs()
    bound = torch.maximum(last * 2.0 ** -bits,
                          torch.full_like(last, 2.0 ** (qmin - 1)))
    assert bool(((xt.double() - total).abs() <= bound).all())


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(11)
    B, n, m = 2, 40, 24
    Jc = (rng.normal(size=(m, n)) / np.sqrt(n)).astype(np.float32)
    w = (10.0 ** rng.uniform(-2, 2, size=(B, m))).astype(np.float32)
    A = rng.normal(size=(B, n, n))
    H = (A @ A.transpose(0, 2, 1) / n + np.eye(n)).astype(np.float32)
    bnd = rng.uniform(0.0, 5.0, size=(B, n)).astype(np.float32)
    Q = (A @ A.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)
    return dict(Jc=Jc, w=w, H=H, bnd=bnd, Q=Q)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# modes whose rounding stands far above float32 summation at these sizes
COARSE = ("tf32", "bf16", "f16")


def _err(got, want, mag):
    """max |got - want| over the magnitude of the entry's terms."""
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)
                        / np.maximum(mag, 1e-30)))


def _held(got, want, mag):
    return _err(got, want, mag) <= TOL


@pytest.mark.parametrize("mode", prec.CARD_MODES, ids=str)
def test_fused_q_twin_in_mode(mode, operands):
    o = operands
    Jw = (o["Jc"][None] * o["w"][:, :, None]).astype(np.float32)
    prod, mag = np_prod(Jw, np.broadcast_to(o["Jc"], Jw.shape), mode,
                        lambda a, b: np.einsum("bki,bkj->bij", a, b))
    n = o["bnd"].shape[1]
    diag = o["bnd"][:, :, None] * np.eye(n)
    want = o["H"] + prod + diag
    mag = np.abs(o["H"]) + mag + np.abs(diag)
    args = [_t(o[k]) for k in ("Jc", "w", "H", "bnd")]
    got = schur.xla_fused_q(*args, mode=mode).numpy()
    assert _held(got, want, mag)
    assert np.array_equal(schur.pallas_fused_q(*args, mode=mode).numpy(), got)
    if mode.kind in COARSE and mode.passes == 1:
        # the mode shows: the IEEE product stands 10x farther from the model
        ieee = schur.xla_fused_q(*args).numpy()
        assert _err(ieee, want, mag) > 10 * _err(got, want, mag)


@pytest.mark.parametrize("mode", prec.CARD_MODES, ids=str)
def test_product_mode_in_mode(mode):
    """Inside a solve's scope on a card (the scope needs no card), @, mm,
    bmm, dot and einsum on float32 tensors are the mode's products;
    float64 products are untouched."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(3, 8, 20)).astype(np.float32)
    b = rng.normal(size=(3, 20, 6)).astype(np.float32)
    want, mag = np_prod(a, b, mode, lambda x, y: x @ y)
    name = next(k for k, v in CUDA_TABLE.items() if v == mode and k)
    ta, tb = _t(a), _t(b)
    if mode == prec.TF32:
        # one-pass TF32 is cuBLAS's switch on the card, no expansion here
        saved = torch.backends.cuda.matmul.allow_tf32
        with prec.scope(name, "cuda"):
            assert torch.backends.cuda.matmul.allow_tf32
            assert torch.equal(ta @ tb, torch.matmul(ta, tb))
        assert torch.backends.cuda.matmul.allow_tf32 == saved
        mode_out = prec.matmul(ta, tb, mode).numpy()
        assert _held(mode_out, want, mag)
        return
    with prec.scope(name, "cuda"):
        outs = {"@": ta @ tb, "matmul": torch.matmul(ta, tb),
                "bmm": torch.bmm(ta, tb), "mm": torch.mm(ta[1], tb[1])[None],
                "einsum": torch.einsum("bik,bkj->bij", ta, tb),
                "einsum...": torch.einsum("...ik,...kj->...ij", ta, tb),
                "dot": torch.stack([torch.dot(ta[i, j], tb[i, :, k])
                                    for i, j, k in np.ndindex(3, 8, 6)]),
                "Tensor.dot": torch.stack([ta[i, j].dot(tb[i, :, k])
                                           for i, j, k in np.ndindex(3, 8, 6)])}
        f64 = ta.double() @ tb.double()
        assert prec.current() == mode
    assert prec.current() == prec.IEEE
    for key, got in outs.items():
        sl = slice(1, 2) if key == "mm" else slice(None)
        assert _held(got.numpy().reshape(want[sl].shape), want[sl],
                     mag[sl]), key
    assert torch.equal(f64, ta.double() @ tb.double())


@pytest.mark.parametrize("mode", prec.CARD_MODES, ids=str)
def test_product_mode_under_torch_func(mode):
    """The oracles' derivatives (torch.func's jacrev, jacfwd, hessian under
    vmap) pass through a mode's rounding as through a cast: the Jacobian
    of A @ z is A to the mode's rounding, the Hessian of z' A' A z is
    2 A' A to it."""
    from torch.func import hessian, jacfwd, jacrev, vmap
    rng = np.random.default_rng(8)
    A = _t(rng.normal(size=(3, 4)).astype(np.float32))
    x = _t(rng.normal(size=(5, 4)).astype(np.float32))
    name = next(k for k, v in CUDA_TABLE.items() if v == mode and k)
    with prec.scope(name, "cuda"):
        jr = vmap(jacrev(lambda z: A @ z))(x)
        jf = vmap(jacfwd(lambda z: torch.einsum("ij,j->i", A, z)))(x)
        hh = vmap(hessian(lambda z: z @ A.T @ (A @ z)))(x)
    rel = 2.0 ** -7 if mode.passes == 1 else 2.0 ** -14
    for J in (jr, jf):
        assert float((J - A).abs().max()) <= rel * float(A.abs().max())
    H = 2 * A.T @ A
    assert float((hh - H).abs().max()) <= 4 * rel * float(H.abs().max())


@pytest.mark.parametrize("mode", prec.CARD_MODES, ids=str)
def test_chol_twin_in_mode(mode, operands):
    """blocked_chol's L satisfies the mode's recurrence on its own entries:
    L[i, j] L[j, j] = Q[i, j] - sum_{k<j} m(L[i, k], L[j, k])."""
    Q = operands["Q"]
    L, d, ok = ch.blocked_chol(_t(Q), mode, block=16)
    assert bool(ok.all())
    L = L.numpy()
    assert np.array_equal(d.numpy(), np.diagonal(L, axis1=1, axis2=2))
    n = Q.shape[-1]
    low = np.tril(np.ones((n, n), bool))
    prod, mag = np_prod(L, L, mode, lambda a, b: a @ b.transpose(0, 2, 1))
    # sum over k < j only: drop the k = j term of each entry
    Ld = np.diagonal(L, axis1=1, axis2=2)
    self_term = np_prod(L, np.broadcast_to(Ld[:, None, :], L.shape), mode,
                        lambda a, b: a * b)
    prod = prod - self_term[0]
    mag = mag - self_term[1]
    lhs = L.astype(np.float64) * Ld[:, None, :]
    rhs = Q.astype(np.float64) - prod
    assert _held(lhs[:, low], rhs[:, low],
                 (np.abs(Q) + mag + np.abs(lhs))[:, low])
    if mode.kind in COARSE and mode.passes == 1:
        Lr = np.linalg.cholesky(Q.astype(np.float64))
        assert np.abs(L - Lr).max() > 10 * np.abs(
            ch.blocked_chol(_t(Q), prec.IEEE)[0].numpy() - Lr).max()


@pytest.mark.parametrize("mode", prec.CARD_MODES, ids=str)
def test_tri_inv_gram_twin_in_mode(mode, operands):
    """blocked_tri_inv's X satisfies the substitution in the mode on its own
    entries, X[r, c] L[r, r] = delta_rc - sum_{k<r} m(L[r, k], X[k, c]),
    and xla_chol_inv_from_L's M is the mode's Gram product of that X."""
    L = ch.xla_chol(_t(operands["Q"]))[0].numpy()
    X = ch.blocked_tri_inv(_t(L), mode=mode).numpy()
    n = L.shape[-1]
    low = np.tril(np.ones((n, n), bool))
    Lstrict = np.tril(L, -1)
    prod, mag = np_prod(Lstrict, X, mode, lambda a, b: a @ b)
    lhs = X.astype(np.float64) * np.diagonal(L, axis1=1, axis2=2)[..., None]
    rhs = np.eye(n) - prod
    assert _held(lhs[:, low], rhs[:, low], (1 + mag + np.abs(lhs))[:, low])
    assert np.all(X[:, ~low] == 0)
    Mt = ch.xla_chol_inv_from_L(_t(L), mode).numpy()
    gram, gmag = np_prod(X, X, mode,
                         lambda a, b: a.transpose(0, 2, 1) @ b)
    assert _held(Mt, gram, gmag)
    assert np.array_equal(ch.pallas_tri_inv_gram(_t(L), mode=mode).numpy(),
                          Mt)


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _one_product_operands(B, n, seed):
    """chip_smoke.py's `one_product_operands`, on the CPU."""
    return _chip_smoke().one_product_operands(B, n, seed, "cpu")


def _f32_sum_pairs(pa, pb, mode):
    """The mode's product of one pair of entries: its part products, each
    exact, summed from +0 in the mode's order with a float32 rounding a
    step."""
    acc = np.zeros(np.broadcast(pa[0], pb[0]).shape, np.float32)
    for i, j in mode.pairs:
        acc = (acc.astype(np.float64) + pa[i] * pb[j]).astype(np.float32)
    return acc


@pytest.mark.parametrize("mode", (prec.IEEE,) + prec.CARD_MODES, ids=str)
def test_one_product_operands_closed_form(mode):
    """On chip_smoke.py's one-product operands the twins of K2 and K3 are
    the closed forms of one product an entry, bit for bit: L[c, c] = 1,
    L[i, c] = a_i, L[i, i] = p (1 / sqrt(p)) as K2 scales a column (p =
    Q[i, i] - m(a_i, a_i)), X[i, c] = -m(a_i, 1), unit diagonals, zeros
    elsewhere;
    with m summed from +0 in the mode's order (the kernels' block and
    trailing updates), so on the card each kernel is its twin bit for bit.
    Where the mode takes at most 3 products the closed form departs from
    the IEEE one, so a kernel running IEEE in its place cannot pass."""
    B, n = 2, 256
    Q, L = _one_product_operands(B, n, 5)
    Q, L = Q.numpy(), L.numpy()
    h = n // 2
    i, c = np.arange(h, n), np.arange(h)
    a = L[:, i, c]

    def closed(md):
        pa = np_parts(a, md)
        one = np_parts(np.ones_like(a), md)
        piv = (Q[:, i, i].astype(np.float64)
               - _f32_sum_pairs(pa, pa, md)).astype(np.float32)
        # the square root and division as the twin takes them (torch's
        # float32 sqrt on the CPU is not always correctly rounded)
        tp = torch.from_numpy(piv)
        Lw = np.eye(n, dtype=np.float32)[None].repeat(B, 0)
        Lw[:, i, c] = a
        Lw[:, i, i] = (tp * (1.0 / torch.sqrt(tp))).numpy()
        X = np.eye(n, dtype=np.float32)[None].repeat(B, 0)
        X[:, i, c] = -_f32_sum_pairs(pa, one, md)
        return Lw, X

    Lw, X = closed(mode)
    if mode.ieee:
        got_L = ch.xla_chol(_t(Q))[0].numpy()
        np.testing.assert_allclose(got_L, Lw, rtol=2e-7, atol=0)
        return
    assert np.array_equal(ch.blocked_chol(_t(Q), mode)[0].numpy(), Lw)
    assert np.array_equal(ch.blocked_tri_inv(_t(L), mode=mode).numpy(), X)
    if mode.passes <= 3:
        Li, Xi = closed(prec.IEEE)
        assert np.any(Lw != Li) and np.any(X != Xi)


# ----------------------------------------------------------------------
# (d) K7 and K5's twins in every mode
# ----------------------------------------------------------------------
def _band32(B, K, nb, seed):
    """tests/test_torch_tridiag.py's band in float32: A_k = G G^T + 3 I,
    B_k = 0.3 N(0, 1), and b ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, K, nb, nb))
    Ad = (G @ G.transpose(0, 1, 3, 2) + 3 * np.eye(nb)).astype(np.float32)
    Bs = (0.3 * rng.normal(size=(B, K - 1, nb, nb))).astype(np.float32)
    return Ad, Bs, rng.normal(size=(B, K, nb)).astype(np.float32)


def _mT(a):
    return np.swapaxes(a, -1, -2)


def _factor_err(Ck, Ci, Ek, Ad, Bs, delta, mode):
    """The largest error of K7's recurrences in `mode` on a factor's own
    entries, over the magnitudes of each entry's terms: S_k = A_k +
    delta I - m(E_{k-1} E_{k-1}^T); C[i, j] C[j, j] = S[i, j] -
    sum_{q<j} m(C[i, q], C[j, q]); Ci[r, c] C[r, r] = delta_rc -
    sum_{q<r} m(C[r, q], Ci[q, c]); E_k = m(B_k Ci_k^T)."""
    K, nb = Ad.shape[1], Ad.shape[-1]
    low = np.tril(np.ones((nb, nb), bool))
    eye = np.eye(nb)
    errs = []
    for k in range(K):
        S = Ad[:, k].astype(np.float64) + delta * eye
        magS = np.abs(S)
        if k:
            p, m = np_prod(Ek[:, k - 1], _mT(Ek[:, k - 1]), mode,
                           lambda a, b: a @ b)
            S, magS = S - p, magS + m
        C, X = Ck[:, k], Ci[:, k]
        d = np.diagonal(C, axis1=1, axis2=2)
        prod, mag = np_prod(C, _mT(C), mode, lambda a, b: a @ b)
        self_term = np_prod(C, np.broadcast_to(d[:, None, :], C.shape),
                            mode, lambda a, b: a * b)
        lhs = C.astype(np.float64) * d[:, None, :]
        rhs = S - (prod - self_term[0])
        errs.append(_err(lhs[:, low], rhs[:, low],
                         (magS + mag + np.abs(lhs))[:, low]))
        prod, mag = np_prod(np.tril(C, -1), X, mode, lambda a, b: a @ b)
        lhs = X.astype(np.float64) * d[:, :, None]
        errs.append(_err(lhs[:, low], (eye - prod)[:, low],
                         (1 + mag + np.abs(lhs))[:, low]))
        if k < K - 1:
            prod, mag = np_prod(Bs[:, k], _mT(X), mode, lambda a, b: a @ b)
            errs.append(_err(Ek[:, k], prod, mag))
    return max(errs)


@pytest.mark.parametrize("mode", prec.CARD_MODES, ids=str)
def test_tridiag_factor_twin_in_mode(mode):
    """xla_tridiag_factor_inv in a mode holds K7's recurrences in that mode
    on its own entries (`_factor_err`); the wrapper takes the Mode on CPU
    tensors and runs that twin; in the coarse one-pass modes the IEEE
    twin stands more than 10x farther from those recurrences."""
    Ad, Bs, _ = _band32(2, 4, 8, seed=21)
    delta = 1e-3
    out = ttp.xla_tridiag_factor_inv(_t(Ad), _t(Bs), delta, mode=mode)
    assert bool(out[3].all())
    err = _factor_err(*(o.numpy() for o in out[:3]), Ad, Bs, delta, mode)
    assert err <= TOL
    wrapped = ttp.pallas_tridiag_factor(_t(Ad), _t(Bs), delta, mode=mode)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, out))
    if mode.kind in COARSE and mode.passes == 1:
        ieee = ttp.xla_tridiag_factor_inv(_t(Ad), _t(Bs), delta)
        assert _factor_err(*(o.numpy() for o in ieee[:3]), Ad, Bs, delta,
                           mode) > 10 * err


def _solve_model(Ci, Ek, b, mode):
    """x of K5's two sweeps in float64, every product the mode's
    (`np_prod`), each vector the twin carries (r, y, x) rounded to float32
    before it is split."""
    def mv(A, v):
        return np_prod(A, v[..., None].astype(np.float32), mode,
                       lambda a, c: a @ c)[0][..., 0]
    K = Ci.shape[1]
    y = []
    for k in range(K):
        r = b[:, k].astype(np.float64)
        if k:
            r = r - mv(Ek[:, k - 1], y[-1])
        y.append(mv(Ci[:, k], r).astype(np.float32))
    x = [None] * K
    for k in range(K - 1, -1, -1):
        r = y[k].astype(np.float64)
        if k < K - 1:
            r = r - mv(_mT(Ek[:, k]), x[k + 1])
        x[k] = mv(_mT(Ci[:, k]), r)
        if k:
            x[k] = x[k].astype(np.float32)
    return np.stack(x, axis=1)


@pytest.mark.parametrize("mode", prec.CARD_MODES, ids=str)
def test_tridiag_solve_twin_in_mode(mode):
    """xla_tridiag_solve_inv in a mode against a float64 run of the same
    sweeps (`_solve_model`), to TOL of the largest entry; the wrapper takes
    the Mode on CPU tensors and runs that twin; in the coarse one-pass
    modes the IEEE twin stands more than 10x farther from the model."""
    Ad, Bs, b = _band32(2, 5, 8, seed=22)
    _, Ci, Ek, _ = ttp.xla_tridiag_factor_inv(_t(Ad), _t(Bs), 1e-3)
    x = ttp.xla_tridiag_solve_inv(Ci, Ek, _t(b), mode=mode)
    want = _solve_model(Ci.numpy(), Ek.numpy(), b, mode)
    scale = np.abs(want).max()
    err = np.abs(x.numpy() - want).max() / scale
    assert err <= TOL
    assert torch.equal(ttp.pallas_tridiag_solve(Ci, Ek, _t(b), mode=mode), x)
    if mode.kind in COARSE and mode.passes == 1:
        ieee = ttp.xla_tridiag_solve_inv(Ci, Ek, _t(b)).numpy()
        assert np.abs(ieee - want).max() / scale > 10 * err


def test_tridiag_ieee_route_is_the_plain_one():
    """With mode None, an IEEE Mode, or a float64 band under any Mode, the
    wrappers run the plain twins as they were before the modes, bit for
    bit: `tridiag_factor` with `block_inverses`, and the two sweeps of
    matrix products written out here."""
    def sweeps(Ci, Ek, b):
        K = Ci.shape[-3]
        y = [Ci[..., 0, :, :] @ b[..., 0, :, None]]
        for k in range(1, K):
            y.append(Ci[..., k, :, :] @ (b[..., k, :, None]
                                         - Ek[..., k - 1, :, :] @ y[-1]))
        x = [None] * K
        x[K - 1] = Ci[..., K - 1, :, :].transpose(-1, -2) @ y[K - 1]
        for k in range(K - 2, -1, -1):
            x[k] = Ci[..., k, :, :].transpose(-1, -2) @ (
                y[k] - Ek[..., k, :, :].transpose(-1, -2) @ x[k + 1])
        return torch.stack(x, dim=-3).squeeze(-1)

    Ad, Bs, b = (_t(a) for a in _band32(2, 4, 6, seed=23))
    for dt, modes in ((torch.float32, (None, prec.IEEE)),
                      (torch.float64, (None, prec.IEEE, prec.Mode("bf16", 1),
                                       prec.TF32))):
        f = tbt.tridiag_factor(Ad.to(dt), Bs.to(dt), 1e-3)
        want = (f.Ck, ttp.block_inverses(f.Ck), f.Ek, f.ok)
        x_want = sweeps(want[1], want[2], b.to(dt))
        for mode in modes:
            got = ttp.pallas_tridiag_factor(Ad.to(dt), Bs.to(dt), 1e-3,
                                            mode=mode)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            assert torch.equal(ttp.pallas_tridiag_solve(
                want[1], want[2], b.to(dt), mode=mode), x_want)


def test_tridiag_factor_stages_are_the_recursion():
    """chip_smoke.py's `tridiag_factor_stages`, K7's twin evaluated on
    every stage at once from a factor's own carried E_{k-1}, is the
    sequential twin `xla_tridiag_factor_inv` bit for bit in every mode,
    given that twin's own E: so on the card it holds each stage of the
    kernel to the twin's stage on the same inputs."""
    Ad, Bs, _ = (_t(a) for a in _band32(2, 6, 8, seed=24))
    delta = torch.tensor([1e-3, 2e-3])
    smoke = _chip_smoke()
    for mode in prec.CARD_MODES:
        seq = ttp.xla_tridiag_factor_inv(Ad, Bs, delta, mode=mode)
        stages = smoke.tridiag_factor_stages(Ad, Bs, delta, seq[2], mode)
        assert all(torch.equal(a, b) for a, b in zip(seq, stages)), mode


@pytest.mark.parametrize("nb", [8, 7])
def test_tridiag_one_product_operands(nb):
    """On chip_smoke.py's `tridiag_one_product_operands`, in the twin of
    every mode, each entry of every product K7 forms (E_{k-1} E_{k-1}^T,
    the Cholesky's and the inverse's updates, B_k Ci_k^T) and of both of
    K5's sweeps sums at most one product of two nonzero entries; and the
    modes of at most 3 products move both twins off their IEEE results,
    so a kernel that ran IEEE in a mode's place cannot equal its twin."""
    K = 3
    (Ad, Bs, delta), (Ci, Ek, b) = _chip_smoke() \
        .tridiag_one_product_operands(K, nb, 5, "cpu")

    def most(a, b_):
        """The largest number of nonzero products in an entry of a @ b_."""
        return int(((a != 0).double() @ (b_ != 0).double()).max())

    for M in (Ci[0], Ek[0]):
        assert int((M != 0).sum(-1).max()) <= 1
        assert int((M != 0).sum(-2).max()) <= 1
    ieee = ttp._moded_factor_inv(Ad, Bs, delta, prec.IEEE)
    x_ieee = ttp.xla_tridiag_solve_inv(Ci, Ek, b, mode=prec.IEEE)
    for mode in (prec.IEEE,) + prec.CARD_MODES:
        Ck, Cx, E, ok = ttp._moded_factor_inv(Ad, Bs, delta, mode)
        assert bool(ok.all())
        for k in range(K):
            Ls, X = torch.tril(Ck[0, k], -1), Cx[0, k]
            assert most(Ls, Ls.T) <= 1 and most(Ls, X) <= 1
            if k < K - 1:
                assert most(Bs[0, k], X.T) <= 1
                assert int((E[0, k] != 0).sum(-1).max()) <= 1
        if not mode.ieee and mode.passes <= 3:
            assert any(bool((a != c).any()) for a, c in
                       zip((Ck, Cx, E), ieee[:3]))
            assert bool((ttp.xla_tridiag_solve_inv(Ci, Ek, b, mode=mode)
                         != x_ieee).any())
    # at the chain path's depth the sweeps stay within fp16's range
    _, (Ci, Ek, b) = _chip_smoke().tridiag_one_product_operands(
        400, nb, 5, "cpu")
    x = ttp.xla_tridiag_solve_inv(Ci, Ek, b, mode=prec.Mode("f16", 1))
    assert bool(torch.isfinite(x).all()) and float(x.abs().max()) < 100


# ----------------------------------------------------------------------
# float32 solves with constant terms (tools/config_matrix.py's float32 row)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name, status", [("circle_nc1", "Optimal"),
                                          ("toy_lp_inf1",
                                           "primal_infeasible")])
def test_float32_derivatives_keep_the_dtype(name, status):
    """torch.func's forward mode gives a float32 term such as z - 2.0 a
    float64 tangent: the Jacobian, Hessian and Hessian product come back
    in the solve's dtype, equal to the float64 ones rounded, and the
    float32 solve on the pallas lane under "high" reaches the float64
    solve's status."""
    from onephase_tpu_torch.models import zoo
    from onephase_tpu_torch.nlp import canonicalize
    x = np.array([[0.5, 0.25]])
    out = {}
    for dt in (torch.float32, torch.float64):
        nlp = canonicalize(getattr(zoo, name)(), dtype=dt, device="cpu")
        xt = torch.as_tensor(x, dtype=dt)
        y = torch.ones(1, nlp.m, dtype=dt)
        out[dt] = (nlp.jac_orig(xt), nlp.lag_hess(xt, y),
                   nlp.hess_prod_fn(xt, y)(xt))
    for got, want in zip(out[torch.float32], out[torch.float64]):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
    nlp = canonicalize(getattr(zoo, name)(), dtype=torch.float32,
                       device="cpu")
    r = onephase_tpu_torch.one_phase_solve(nlp, options=dict(
        OPTS, **{"kkt.linear_solver_type": "pallas",
                 "matmul_precision": "high"}))
    assert r.status == status
