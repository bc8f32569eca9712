"""The arithmetic of `Params.matmul_precision`: what each name the JAX
package accepts means on a device, and one definition of that arithmetic
for the CUDA kernels and their plain twins.

The JAX package hands the name to `jax.default_matmul_precision`
(onephase_tpu/ipm/core.py:63-74), which reaches every `jnp.dot` it traces,
the dots inside its Pallas kernels included.  The names and their meaning
are the installed JAX's (jax/_src/lax/lax.py, the `Precision` docstring
and `_precision_strings`; the enum of `jax_default_matmul_precision` in
jax/_src/config.py; the `DotAlgorithmPreset` docstring):

- DEFAULT ("default", "bfloat16", None, and "" which the JAX package maps
  to no scope at all) and HIGH ("high", "tensorfloat32"): on a GPU,
  TensorFloat-32, one pass;
- HIGHEST ("highest", "float32") and the preset F32_F32_F32: IEEE float32;
- the presets TF32_TF32_F32 (one pass), TF32_TF32_F32_X3, BF16_BF16_F32
  (one pass) and its _X3, _X6 and _X9, and F16_F16_F32: their input type,
  float32 accumulation and their number of passes;
- the presets without float32 output or input (the four ANY_F8_*,
  F16_F16_F16, BF16_BF16_BF16, F64_F64_F64) and any other string: refused
  with a ValueError, as JAX's enum check refuses an unknown name.

On the CPU the JAX package's solver runs "", "default", "bfloat16",
"high", "tensorfloat32", "highest", "float32" and F32_F32_F32, all as
plain float32 and float64, and raises on every other preset (decided by
running it on each value: tests/test_torch_matmul_precision.py); the port
does the same.  The knob touches float32 products only: a float64 product
is IEEE float64 under every accepted name.

A `Mode` is the rounding kind of the operands ("none", "tf32", "bf16",
"f16") and the number of products a pass set takes (1, 3, 6, 9).  Its
arithmetic, the same in the kernels (csrc/mm_mode.cuh) and in the twins
here: every product of two matrix entries becomes a product of operands
rounded to the mode's input type.  A split mode expands each operand into
parts, hi = r(x), mid = r(x - hi), lo = r(x - hi - mid) (two parts for 3
products, three for 6 and 9), and takes the part products (i, j) with
i + j <= 1 (3 products), i + j <= 2 (6) or all nine, summed smallest
first: (2, 2), (2, 1), (1, 2), (2, 0), (1, 1), (0, 2), (1, 0), (0, 1),
(0, 0).  Sums, divisions and square roots stay float32.  A product of two
rounded operands is exact in float32 (bf16 x bf16 is 8 + 8 significand
bits, tf32 x tf32 and fp16 x fp16 11 + 11), so a kernel's FFMA on rounded
operands computes what a tensor-core product of that type computes, up to
the order of the sums.

Rounding: TF32 rounds to nearest with ties away from zero on the 10-bit
fraction (the kernels' `cvt.rna.tf32.f32`; here integer arithmetic on the
bits, since torch has no tf32 type), keeping subnormals, infinities and
NaNs; bf16 and fp16 round to nearest even (a round trip through
torch.bfloat16 / torch.float16, `__float2bfloat16_rn` / `__float2half_rn`
in CUDA), with fp16's narrow range (overflow to inf, gradual underflow).

On a CUDA device the solver runs one-pass TF32 as JAX's GPU default does,
through cuBLAS (`torch.backends.cuda.matmul.allow_tf32`) and the kernels'
TF32 mode, and the other non-IEEE modes through `ProductMode`, which
expands every float32 matrix product of plain PyTorch code into the
mode's part products, each in IEEE float32, and through the kernels'
moded variants.  `linalg.cholesky_ex`, `solve_triangular`, `eigh` and
elementwise arithmetic are left alone, as JAX on a GPU leaves cuSOLVER
alone.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import torch
from torch.overrides import TorchFunctionMode

KINDS = ("none", "tf32", "bf16", "f16")


@dataclass(frozen=True)
class Mode:
    """Rounding kind of the operands and products a pass set."""
    kind: str = "none"
    passes: int = 1

    @property
    def ieee(self) -> bool:
        return self.kind == "none"

    @property
    def parts(self) -> int:
        return {1: 1, 3: 2, 6: 3, 9: 3}[self.passes]

    @property
    def pairs(self):
        """The part products (i, j), smallest first."""
        top = {1: 0, 3: 1, 6: 2, 9: 4}[self.passes]
        order = ((2, 2), (2, 1), (1, 2), (2, 0), (1, 1), (0, 2), (1, 0),
                 (0, 1), (0, 0))
        return tuple((i, j) for i, j in order
                     if i + j <= top and max(i, j) < self.parts)

    @property
    def code(self) -> int:
        """The kernels' mode argument: 16 * kind index + passes (0 for
        IEEE)."""
        return 0 if self.ieee else 16 * KINDS.index(self.kind) + self.passes

    def __str__(self):
        return "ieee" if self.ieee else (
            self.kind if self.passes == 1 else f"{self.kind}_x{self.passes}")


IEEE = Mode()
TF32 = Mode("tf32", 1)

# the moded kernels' modes, in the order the card checks them
CARD_MODES = (TF32, Mode("tf32", 3), Mode("bf16", 1), Mode("bf16", 3),
              Mode("bf16", 6), Mode("bf16", 9), Mode("f16", 1))

# name -> (mode on a CUDA device, runs on the CPU)
_TABLE = {
    None: (TF32, True), "": (TF32, True), "default": (TF32, True),
    "bfloat16": (TF32, True), "high": (TF32, True),
    "tensorfloat32": (TF32, True),
    "highest": (IEEE, True), "float32": (IEEE, True),
    "F32_F32_F32": (IEEE, True),
    "TF32_TF32_F32": (TF32, False),
    "TF32_TF32_F32_X3": (Mode("tf32", 3), False),
    "BF16_BF16_F32": (Mode("bf16", 1), False),
    "BF16_BF16_F32_X3": (Mode("bf16", 3), False),
    "BF16_BF16_F32_X6": (Mode("bf16", 6), False),
    "BF16_BF16_F32_X9": (Mode("bf16", 9), False),
    "F16_F16_F32": (Mode("f16", 1), False),
}
# presets the enum knows whose product is not float32 in, float32 out
_NOT_F32 = {
    "ANY_F8_ANY_F8_F32": "takes fp8 operands, not float32",
    "ANY_F8_ANY_F8_F32_FAST_ACCUM": "takes fp8 operands, not float32",
    "ANY_F8_ANY_F8_ANY": "takes fp8 operands, not float32",
    "ANY_F8_ANY_F8_ANY_FAST_ACCUM": "takes fp8 operands, not float32",
    "F16_F16_F16": "has no float32 output (fp16 accumulation)",
    "BF16_BF16_BF16": "has no float32 output (bf16 accumulation)",
    "F64_F64_F64": "takes float64 operands, not float32",
}
# every value of jax_default_matmul_precision's enum, in its order
JAX_ENUM = (
    "default", "high", "highest", "bfloat16", "tensorfloat32", "float32",
    "ANY_F8_ANY_F8_F32", "ANY_F8_ANY_F8_F32_FAST_ACCUM", "ANY_F8_ANY_F8_ANY",
    "ANY_F8_ANY_F8_ANY_FAST_ACCUM", "F16_F16_F16", "F16_F16_F32",
    "BF16_BF16_BF16", "BF16_BF16_F32", "BF16_BF16_F32_X3",
    "BF16_BF16_F32_X6", "BF16_BF16_F32_X9", "TF32_TF32_F32",
    "TF32_TF32_F32_X3", "F32_F32_F32", "F64_F64_F64")


def resolve(name, device_type: str) -> Mode:
    """The mode of `Params.matmul_precision=name` on a device of type
    `device_type` ("cuda" or "cpu"); a pure function of its arguments.
    ValueError for a name no device runs, or one this device's JAX
    refuses."""
    if name in _NOT_F32:
        raise ValueError(f"matmul_precision={name!r} {_NOT_F32[name]}: "
                         "the knob sets float32 matrix products only")
    if name not in _TABLE:
        raise ValueError(
            f"matmul_precision={name!r}: expected one of "
            f"{sorted(k for k in _TABLE if k)} (or None / '')")
    mode, on_cpu = _TABLE[name]
    if device_type == "cuda":
        return mode
    if not on_cpu:
        raise ValueError(f"matmul_precision={name!r} is not supported on "
                         f"{device_type} (the JAX package's dot_general "
                         "refuses it there)")
    return IEEE


# ----------------------------------------------------------------------
# rounding and split
# ----------------------------------------------------------------------
def round_to(x, kind: str):
    """float32 `x` rounded to `kind`'s input type, returned in float32."""
    if kind == "none":
        return x
    if kind == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if kind == "f16":
        return x.to(torch.float16).to(torch.float32)
    if kind != "tf32":
        raise ValueError(f"unknown rounding kind {kind!r}")
    # ties away on the magnitude: add half of the 13 dropped bits, then
    # clear them (a carry into the exponent rounds up a binade, or to inf);
    # x + (r - x), exact, passes derivatives through as the casts above do
    xd = x.detach()
    u = xd.contiguous().view(torch.int32)
    r = ((u + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(xd) & (r != xd), x + (r - xd), x)


def split(x, mode: Mode):
    """The parts of float32 `x` in `mode` (hi[, mid[, lo]])."""
    parts, rest = [], x
    for p in range(mode.parts):
        part = round_to(rest, mode.kind)
        parts.append(part)
        if p + 1 < mode.parts:
            rest = rest - part
    return parts


def _sum_pairs(fn, pa, pb, mode: Mode):
    """The sum of fn(pa[i], pb[j]) over the mode's part products, smallest
    first."""
    out = None
    for i, j in mode.pairs:
        t = fn(pa[i], pb[j])
        out = t if out is None else out + t
    return out


def _bilinear(fn, a, b, mode: Mode):
    """fn(a, b), bilinear in its two operands, in `mode` (float32 operands;
    IEEE or anything else: fn(a, b))."""
    if mode.ieee or a.dtype != torch.float32 or b.dtype != torch.float32:
        return fn(a, b)
    return _sum_pairs(fn, split(a, mode), split(b, mode), mode)


def matmul(a, b, mode: Mode = IEEE):
    """a @ b with every product in `mode` (the twins' product function)."""
    with ieee_products():
        return _bilinear(torch.matmul, a, b, mode)


def matmul_parts(pa, pb, mode: Mode):
    """a @ b in `mode` from the operands' parts (`split`), for twins that
    split each entry once."""
    with ieee_products():
        return _sum_pairs(torch.matmul, pa, pb, mode)


# ----------------------------------------------------------------------
# the scope of a solve
# ----------------------------------------------------------------------
_CURRENT = contextvars.ContextVar("onephase_matmul_mode", default=IEEE)


def current() -> Mode:
    """The mode of the innermost `scope` (IEEE outside any)."""
    return _CURRENT.get()


def kernel_mode(t, mode=None) -> Mode:
    """The mode a kernel wrapper runs for its operand `t`: `mode`, or the
    current scope's, for a float32 tensor; IEEE for float64 (the knob
    touches float32 products only)."""
    mode = current() if mode is None else mode
    return mode if t.dtype == torch.float32 else IEEE


def _einsum_steps(eq, n_ops):
    """torch.einsum's left-to-right pairwise plan of `eq` over `n_ops`
    operands: the equation of each step ("ab,bc->ac")."""
    lhs, out = eq.replace(" ", "").split("->")
    terms = lhs.split(",")
    steps, cur = [], terms[0]
    for k in range(1, n_ops):
        later = set("".join(terms[k + 1:]) + out)
        keep = "".join(dict.fromkeys(
            c for c in cur + terms[k] if c in later))
        res = out if k == n_ops - 1 else keep
        steps.append(f"{cur},{terms[k]}->{res}")
        cur = res
    return steps


def _einsum(eq, *ops):
    """einsum in the current mode: a product of two operands is bilinear
    in them; more operands are contracted pairwise, left to right, as
    torch.einsum does, each step a product."""
    if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
        ops = tuple(ops[0])
    mode = current()
    if len(ops) == 1:
        return torch.einsum(eq, *ops)
    if len(ops) == 2:
        return _bilinear(lambda x, y: torch.einsum(eq, x, y), *ops, mode)
    if "..." in eq or "->" not in eq:
        raise NotImplementedError(
            f"einsum {eq!r} of {len(ops)} operands in matmul mode {mode}: "
            "write the output subscripts and no ellipsis")
    acc = ops[0]
    for step, op in zip(_einsum_steps(eq, len(ops)), ops[1:]):
        acc = _bilinear(lambda x, y, s=step: torch.einsum(s, x, y), acc, op,
                        mode)
    return acc


def _addmm_like(prod):
    def fn(inp, m1, m2, *, beta=1, alpha=1, out=None):
        if out is not None:
            raise NotImplementedError("out= under a matmul mode")
        p = _bilinear(prod, m1, m2, current())
        if alpha != 1:
            p = p * alpha
        return p + (inp if beta == 1 else beta * inp)
    return fn


def _product(prod):
    def fn(a, b, *, out=None):
        if out is not None:
            raise NotImplementedError("out= under a matmul mode")
        return _bilinear(prod, a, b, current())
    return fn


def _handlers():
    T = torch.Tensor
    prods = {torch.matmul: torch.matmul, T.matmul: torch.matmul,
             T.__matmul__: torch.matmul, torch.mm: torch.mm,
             T.mm: torch.mm, torch.bmm: torch.bmm, T.bmm: torch.bmm,
             torch.mv: torch.mv, T.mv: torch.mv, torch.dot: torch.dot,
             T.dot: torch.dot}
    table = {f: _product(p) for f, p in prods.items()}
    for f, p in ((torch.addmm, torch.mm), (T.addmm, torch.mm),
                 (torch.baddbmm, torch.bmm), (T.baddbmm, torch.bmm)):
        table[f] = _addmm_like(p)
    table[torch.einsum] = _einsum
    return table


_HANDLERS = _handlers()


class ProductMode(TorchFunctionMode):
    """Expands every float32 matrix product of plain PyTorch code into the
    part products of the current mode: torch.matmul, mm, bmm, mv, dot,
    addmm, baddbmm, einsum and Tensor.__matmul__ (and their Tensor
    methods), as JAX's knob reaches every jnp.dot, vector dots included.
    Other functions pass through untouched; inside the expansion the mode
    is off, so each part product runs in IEEE float32."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        handler = _HANDLERS.get(func, func)
        return handler(*args, **(kwargs or {}))


@contextlib.contextmanager
def ieee_products():
    """No ProductMode inside: products in IEEE float32 (the twins'
    explicit products)."""
    with torch._C.DisableTorchFunction():
        yield


def twin_matmul(a, b, mode=None):
    """a @ b in a plain twin: with `mode` None, as any PyTorch code in the
    current scope; with a Mode, every product in that mode (IEEE ones
    included, whatever the scope)."""
    return a @ b if mode is None else matmul(a, b, mode)


@contextlib.contextmanager
def scope(name, device_type: str):
    """Run the block in `Params.matmul_precision=name` on `device_type`:
    the kernels read `current()`; plain PyTorch products take cuBLAS's TF32
    switch (`torch.backends.cuda.matmul.allow_tf32`: one-pass TF32) or
    `ProductMode` (the emulated modes), and full float32 otherwise.  The
    switch is restored on exit."""
    mode = resolve(name, device_type)
    switch = torch.backends.cuda.matmul
    saved = switch.allow_tf32
    token = _CURRENT.set(mode)
    switch.allow_tf32 = mode == TF32
    try:
        if mode.ieee or mode == TF32:
            yield mode
        else:
            with ProductMode():
                yield mode
    finally:
        switch.allow_tf32 = saved
        _CURRENT.reset(token)
