"""Fused Schur-complement formation: Q = H + Jc^T diag(w) Jc + diag(bnd).

The reference's hottest line item (42.1% of its runtime in the sparse
triple products, docs/one-phase.tex:901-912).

- `pallas_fused_q`: the kernel wrapper of the `pallas` lane.  It replaces
  the TPU kernel onephase_tpu/ops/schur.py:pallas_fused_q
  (`_fused_q_kernel`) with the CUDA C++ kernel `csrc/fused_q.cu`, which
  forms the lower tile pairs only and mirrors them: on and below the
  diagonal, the values of a full-grid product bit for bit; above it, the
  mirrored rank-m part plus H in its own place.
- `pallas_fused_q_tri`: the triangle-tiled form of the same function.  It
  replaces the TPU kernel onephase_tpu/ops/schur.py:pallas_fused_q_tri
  (`_fused_q_tri_kernel`) with the same launch of `csrc/fused_q.cu`,
  which already tiles only the lower pairs.  No lane dispatches it, in
  either package.  The kernel's lower-triangular mode is the Gram half of
  `ops/cholesky.py:pallas_tri_inv_gram`.
- `xla_fused_q`: the plain PyTorch version of the same function (the port
  of the JAX package's XLA expression); the other lanes use it, and the
  wrapper uses it for CPU tensors.

Matmul modes (`Params.matmul_precision`, ops/precision.py): the wrappers
take `mode=` (default: the solve's scope) and launch the kernel's moded
variant for a non-IEEE float32 mode, every product J[k, i] w[k] x J[k, j]
taken with both operands rounded (the first after the scaling, as the
JAX kernel forms `ji * w` before its dot); `xla_fused_q(..., mode=)` is
its twin.  Launches are tallied by mode (`ops.LAUNCH_MODES`).

Shapes are batch-first: Jc (m, n) shared or (B, m, n), w (B, m), H None,
shared (n, n) or (B, n, n), bnd (B, n) -> Q (B, n, n).  A shared Jc or H is
passed to the kernel with batch stride 0, never copied B times.
"""

from __future__ import annotations

import torch

from . import _build
from . import count_launch
from . import precision

_FLOATS = (torch.float32, torch.float64)


def xla_fused_q(Jc, w, H, bnd, mxu_dtype=None, mode=None):
    """Q = H + J^T diag(w) J + diag(bnd) in plain PyTorch.  H is None for
    declared-zero Hessians (LPs).

    `mxu_dtype` (torch.bfloat16) forms the rank-m update by the scale-split
    J^T W J = (sqrt(w) J)^T (sqrt(w) J) from operands rounded to bf16, with
    float32 accumulation (onephase_tpu/ops/schur.py:189-215): the sqrt
    halves the weights' exponent range so bf16 holds them, and the ~3e-3
    relative error only touches the preconditioner.  A product of two bf16
    values is exact in float32, so the float32 product of the rounded
    operands gives the reference's values up to summation order.

    `mode`, as for the wrappers: None takes the current scope (the product
    is plain PyTorch code, which the scope's ProductMode or cuBLAS switch
    sets: the `xla`/`invchol` lanes); a Mode takes the rank-m product's
    every term in that mode (precision.twin_matmul): the kernel's twin."""
    B, n = bnd.shape
    if Jc.shape[-2] > 0:
        if mxu_dtype is not None:
            Js = (Jc * torch.sqrt(w)[:, :, None]).to(mxu_dtype)
            Js = Js.to(torch.float32)
            upd = (Js.transpose(-1, -2) @ Js).to(bnd.dtype)
        else:
            upd = precision.twin_matmul(
                (Jc * w[:, :, None]).transpose(-1, -2), Jc, mode)
        Q = upd if H is None else H + upd
    elif H is None:
        Q = torch.zeros(B, n, n, dtype=bnd.dtype, device=bnd.device)
    else:
        Q = H.expand(B, n, n)
    return Q + torch.diag_embed(bnd)


def _check_operand(t, name, shapes, dtype, idx):
    """t has `dtype`, lies on CUDA device `idx`, has one of `shapes` and is
    contiguous (the kernel reads it as a dense array); else a ValueError
    naming what differs.  The message is formatted only on failure."""
    if t.dtype is not dtype or t.get_device() != idx:
        raise ValueError(f"fused_q: {name} is {t.dtype} on {t.device}, "
                         f"expected {dtype} on cuda:{idx}")
    if t.shape not in shapes:
        raise ValueError(f"fused_q: {name} has shape {tuple(t.shape)}, "
                         f"expected one of {shapes}")
    if not t.is_contiguous():
        raise ValueError(f"fused_q: {name} must be contiguous")


def _cuda_operands(Jc, w, H, bnd):
    """Validate the operands of a fused-Q kernel on the card; (B, m, n)."""
    if not bnd.is_cuda:
        raise ValueError(f"fused_q: no kernel for device {bnd.device}")
    B, n = bnd.shape
    m = Jc.shape[-2]
    dt, idx = bnd.dtype, bnd.get_device()
    if dt not in _FLOATS:
        raise TypeError(f"fused_q: dtype {dt} is not float32/float64")
    _check_operand(bnd, "bnd", [(B, n)], dt, idx)
    _check_operand(Jc, "Jc", [(m, n), (B, m, n)], dt, idx)
    _check_operand(w, "w", [(B, m)], dt, idx)
    if H is not None:
        _check_operand(H, "H", [(n, n), (B, n, n)], dt, idx)
    return B, m, n


def _launch_counted(Jc, w, H, bnd, counter, mode):
    """Q from the kernel of `csrc/fused_q.cu` for CUDA tensors, counted in
    LAUNCHES[counter] (and by mode); the plain version for CPU tensors.
    The mode is resolved once, here."""
    mode = precision.kernel_mode(bnd, mode)
    if bnd.is_cpu:
        return xla_fused_q(Jc, w, H, bnd, mode=mode)
    B, m, n = _cuda_operands(Jc, w, H, bnd)
    Q = bnd.new_empty((B, n, n))
    if B == 0 or n == 0:
        return Q
    launch_fused_q(Jc, w, H, bnd, Q, mode=mode)
    count_launch(counter, mode)
    return Q


def pallas_fused_q(Jc, w, H, bnd, mode=None):
    """Q = H + Jc^T diag(w) Jc + diag(bnd): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; in matmul mode `mode`
    (default: the current scope's, ops/precision.py)."""
    return _launch_counted(Jc, w, H, bnd, "fused_q", mode)


def pallas_fused_q_tri(Jc, w, H, bnd, mode=None):
    """The same Q as `pallas_fused_q`, with the rank-m product formed for
    the lower tile pairs only and mirrored, so Q - H is symmetric bit for
    bit: the same kernel, its launches counted apart; the plain version
    for CPU tensors.

    As in the JAX package, `fused_q` does not dispatch here: the function
    is kept as the symmetric-tiling building block and held by its tests."""
    return _launch_counted(Jc, w, H, bnd, "fused_q_tri", mode)


def _batch_stride(t):
    """Elements between instances: 0 for a shared 2-D operand or None."""
    return 0 if (t is None or t.dim() == 2) else t.shape[-2] * t.shape[-1]


def launch_fused_q(Jc, w, H, bnd, Q, lower: bool = False, mode=None):
    """Launch `csrc/fused_q.cu` on validated operands (w, H, bnd may be
    None).  `lower` declares Jc square and lower triangular, so tile (i, j),
    i >= j, sums only over rows k >= i: the Gram product of the triangular
    inverse (ops/cholesky.py).  `mode`: the matmul mode of a float32 Q (the
    moded instantiation; None: the current scope's); float64 runs IEEE."""
    B, n = Q.shape[0], Q.shape[-1]
    err = _build.launch(
        "op_fused_q", Q, _build.ptr(Jc), _batch_stride(Jc), _build.ptr(w),
        _build.ptr(H), _batch_stride(H), _build.ptr(bnd), Q.data_ptr(), B,
        Jc.shape[-2], n, int(lower), precision.kernel_mode(Q, mode).code)
    _build.check(err, "fused_q")


def fused_q(Jc, w, H, bnd, use_pallas: bool, mxu_dtype=None):
    """Dispatch: the hand kernel on the `pallas` lane, plain PyTorch on the
    `xla`/`invchol` lanes.  With `mxu_dtype` set every lane takes the plain
    bf16 scale-split, as the JAX package's dispatch does
    (onephase_tpu/ops/schur.py:218-229): the kernel forms Q in its input
    dtype only, so it is not launched under `kkt.q_form_dtype="bf16"`."""
    if use_pallas and mxu_dtype is None:
        return pallas_fused_q(Jc, w, H, bnd)
    return xla_fused_q(Jc, w, H, bnd, mxu_dtype)
