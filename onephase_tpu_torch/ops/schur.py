"""Fused Schur-complement formation: Q = H + Jc^T diag(w) Jc + diag(bnd).

The reference's hottest line item (42.1% of its runtime in the sparse
triple products, docs/one-phase.tex:901-912).

- `pallas_fused_q`: the kernel wrapper of the `pallas` lane.  It replaces
  the TPU kernel onephase_tpu/ops/schur.py:pallas_fused_q
  (`_fused_q_kernel`) with the CUDA C++ kernel `csrc/fused_q.cu`.
- `xla_fused_q`: the plain PyTorch version of the same function (the port
  of the JAX package's XLA expression); the other lanes use it, and the
  wrapper uses it for CPU tensors.

Shapes are batch-first: Jc (m, n) shared or (B, m, n), w (B, m), H None,
shared (n, n) or (B, n, n), bnd (B, n) -> Q (B, n, n).  A shared Jc or H is
passed to the kernel with batch stride 0, never copied B times.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from . import _build

_FLOATS = (torch.float32, torch.float64)


def xla_fused_q(Jc, w, H, bnd):
    """Q = H + J^T diag(w) J + diag(bnd) in plain PyTorch.  H is None for
    declared-zero Hessians (LPs)."""
    B, n = bnd.shape
    if Jc.shape[-2] > 0:
        upd = (Jc * w[:, :, None]).transpose(-1, -2) @ Jc
        Q = upd if H is None else H + upd
    elif H is None:
        Q = torch.zeros(B, n, n, dtype=bnd.dtype, device=bnd.device)
    else:
        Q = H.expand(B, n, n)
    return Q + torch.diag_embed(bnd)


def _check_operand(t, name, shapes, dtype, device):
    if t.dtype != dtype or t.device != device:
        raise ValueError(f"fused_q: {name} is {t.dtype} on {t.device}, "
                         f"expected {dtype} on {device}")
    if tuple(t.shape) not in shapes:
        raise ValueError(f"fused_q: {name} has shape {tuple(t.shape)}, "
                         f"expected one of {shapes}")
    if not t.is_contiguous():
        raise ValueError(f"fused_q: {name} must be contiguous")


def pallas_fused_q(Jc, w, H, bnd):
    """Q = H + Jc^T diag(w) Jc + diag(bnd): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if bnd.device.type == "cpu":
        return xla_fused_q(Jc, w, H, bnd)
    if bnd.device.type != "cuda":
        raise ValueError(f"fused_q: no kernel for device {bnd.device}")
    B, n = bnd.shape
    m = Jc.shape[-2]
    dt, dev = bnd.dtype, bnd.device
    if dt not in _FLOATS:
        raise TypeError(f"fused_q: dtype {dt} is not float32/float64")
    _check_operand(bnd, "bnd", [(B, n)], dt, dev)
    _check_operand(Jc, "Jc", [(m, n), (B, m, n)], dt, dev)
    _check_operand(w, "w", [(B, m)], dt, dev)
    if H is not None:
        _check_operand(H, "H", [(n, n), (B, n, n)], dt, dev)
    Q = torch.empty(B, n, n, dtype=dt, device=dev)
    if B == 0 or n == 0:
        return Q
    launch_fused_q(Jc, w, H, bnd, Q, lower=False)
    LAUNCHES["fused_q"] += 1
    return Q


def launch_fused_q(Jc, w, H, bnd, Q, lower: bool):
    """Launch `csrc/fused_q.cu` on validated operands (w, H, bnd may be
    None).  `lower` declares Jc lower triangular (square), so each output
    tile sums only over rows k >= max(its row, its column) — the Gram
    product of the triangular inverse (ops/cholesky.py)."""
    B, n = Q.shape[0], Q.shape[-1]
    m = Jc.shape[-2]
    jc_bs = 0 if Jc.dim() == 2 else m * n
    h_bs = 0 if (H is None or H.dim() == 2) else n * n
    with torch.cuda.device(Q.device):
        err = _build.entry("op_fused_q", Q.dtype)(
            _build.ptr(Jc), jc_bs, _build.ptr(w), _build.ptr(H), h_bs,
            _build.ptr(bnd), _build.ptr(Q), B, m, n, int(lower),
            _build.stream_ptr(Q))
    _build.check(err, "fused_q")


def fused_q(Jc, w, H, bnd, use_pallas: bool):
    """Dispatch: the hand kernel on the `pallas` lane, plain PyTorch on the
    `xla`/`invchol` lanes."""
    if use_pallas:
        return pallas_fused_q(Jc, w, H, bnd)
    return xla_fused_q(Jc, w, H, bnd)
