"""Block-tridiagonal factor and solve kernels of the chain path's `pallas`
lane.

Port of onephase_tpu/ops/tridiag_pallas.py.  Kernel wrappers (CUDA tensors
-> the CUDA C++ kernel of `csrc/tridiag.cu`, CPU tensors -> the plain
version):

- `pallas_tridiag_factor` replaces onephase_tpu/ops/tridiag_pallas.py:
  pallas_tridiag_factor (`_factor_kernel`): the whole K-step recursion
  C_k = chol(A_k + delta I - E_{k-1} E_{k-1}^T), Ci_k = C_k^{-1},
  E_k = B_k Ci_k^T in one launch.  Ad (B, K, nb, nb), Bs (B, K-1, nb, nb),
  delta a float or (B,) -> (Ck, Ci, Ek, ok).  Its plain version is
  `xla_tridiag_factor_inv`: `tridiag_factor` + `block_inverses`, which is
  exactly the JAX package's hybrid factor on its `pallas` lane.
- `pallas_tridiag_solve` replaces onephase_tpu/ops/tridiag_pallas.py:
  pallas_tridiag_solve (`_fwd_kernel`, `_bwd_kernel`): L L^T x = b from the
  block inverses, y_k = Ci_k (b_k - E_{k-1} y_{k-1}) then
  x_k = Ci_k^T (y_k - E_k^T x_{k+1}), both sweeps in one launch.
  Ci (B, K, nb, nb), Ek (B, K-1, nb, nb), b (B, K, nb) -> x (B, K, nb).
  Its plain version is `xla_tridiag_solve_inv`, the same two matvec sweeps.

The Pallas plumbing (padding to the TPU's (8, 128) tiling, the `_View`
adapter, interpret mode) is not ported: the CUDA kernels mask the ragged
edge themselves.  The kernels take nb <= 64 (the repo's chain shapes use
nb <= 32); the wrappers raise on larger blocks.  The kernels run IEEE
float32 and float64 only: a non-IEEE `matmul_precision` mode on float32
CUDA tensors raises NotImplementedError (`check_ieee`) instead of running
IEEE (the chain and banded `xla` lanes take every mode).
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from . import _build
from . import precision
from .block_tridiag import tridiag_factor

_FLOATS = (torch.float32, torch.float64)
MAX_NB = 64


def block_inverses(Ck):
    """C_k^{-1} for every diagonal Cholesky block: one batched triangular
    solve against the identity (parallel over K)."""
    eye = torch.eye(Ck.shape[-1], dtype=Ck.dtype, device=Ck.device)
    return torch.linalg.solve_triangular(Ck, eye.expand_as(Ck), upper=False)


def xla_tridiag_factor_inv(Ad, Bs, delta):
    """Plain version of the factor kernel: (Ck, Ci, Ek, ok)."""
    f = tridiag_factor(Ad, Bs, delta)
    return f.Ck, block_inverses(f.Ck), f.Ek, f.ok


def xla_tridiag_solve_inv(Ci, Ek, b):
    """Plain version of the solve kernel: the forward and backward matvec
    sweeps against the block inverses."""
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


def check_ieee(dtype, device, mode=None):
    """K5 and K7 take no matmul mode: NotImplementedError for a non-IEEE
    `mode` (default: the current scope's) on float32 CUDA operands."""
    mode = precision.current() if mode is None else mode
    if (torch.device(device).type == "cuda" and dtype == torch.float32
            and not mode.ieee):
        raise NotImplementedError(
            f"matmul mode {mode} is not ported to the block-tridiagonal "
            "kernels K5 (tridiag_solve) and K7 (tridiag_factor), which run "
            "IEEE float32 only: use kkt.linear_solver_type='xla' or "
            "matmul_precision='highest'")


def _check_band(name, D, S):
    """D (B, K, nb, nb) and S (B, K-1, nb, nb), one dtype and device."""
    if D.dim() != 4 or D.shape[-1] != D.shape[-2]:
        raise ValueError(f"{name}: expected (B, K, nb, nb) diagonal blocks, "
                         f"got {tuple(D.shape)}")
    B, K, nb, _ = D.shape
    if tuple(S.shape) != (B, max(K - 1, 0), nb, nb):
        raise ValueError(f"{name}: subdiagonal blocks {tuple(S.shape)} do "
                         f"not match diagonal blocks {tuple(D.shape)}")
    if D.dtype not in _FLOATS or S.dtype != D.dtype:
        raise TypeError(f"{name}: blocks must share one of float32/float64, "
                        f"got {D.dtype} and {S.dtype}")
    if S.device != D.device or D.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: blocks on {D.device} and {S.device}")
    if D.device.type == "cuda":
        if nb > MAX_NB:
            raise ValueError(f"{name}: the CUDA kernel takes nb <= {MAX_NB}, "
                             f"got {nb}")
        if not (D.is_contiguous() and S.is_contiguous()):
            raise ValueError(f"{name}: CUDA inputs must be contiguous")


def pallas_tridiag_factor(Ad, Bs, delta):
    """Factor tridiag(B, A + delta I, B^T): (Ck, Ci, Ek, ok) with the
    diagonal Cholesky blocks, their inverses, the subdiagonal blocks of L
    and ok (B,) bool = every pivot finite and > 0."""
    _check_band("tridiag_factor", Ad, Bs)
    if Ad.device.type == "cpu":
        return xla_tridiag_factor_inv(Ad, Bs, delta)
    check_ieee(Ad.dtype, Ad.device)
    B, K, nb, _ = Ad.shape
    dvec = torch.as_tensor(delta, dtype=Ad.dtype, device=Ad.device)
    dvec = dvec.expand(B).contiguous()
    Ck = torch.empty_like(Ad)
    Ci = torch.empty_like(Ad)
    Ek = torch.empty_like(Bs)
    ok = torch.ones(B, dtype=torch.int32, device=Ad.device)
    if B > 0 and K > 0 and nb > 0:
        with torch.cuda.device(Ad.device):
            err = _build.entry("op_tridiag_factor", Ad.dtype)(
                Ad.data_ptr(), Bs.data_ptr(), dvec.data_ptr(),
                Ck.data_ptr(), Ci.data_ptr(), Ek.data_ptr(), ok.data_ptr(),
                B, K, nb, _build.stream_ptr(Ad))
        _build.check(err, "tridiag_factor")
        LAUNCHES["tridiag_factor"] += 1
    return Ck, Ci, Ek, ok != 0


def pallas_tridiag_solve(Ci, Ek, b):
    """Solve L L^T x = b given the factor's block inverses Ci and the
    subdiagonal blocks Ek of L; b (B, K, nb)."""
    _check_band("tridiag_solve", Ci, Ek)
    if tuple(b.shape) != tuple(Ci.shape[:3]):
        raise ValueError(f"tridiag_solve: b has shape {tuple(b.shape)}, "
                         f"expected {tuple(Ci.shape[:3])}")
    if b.dtype != Ci.dtype or b.device != Ci.device:
        raise ValueError(f"tridiag_solve: b is {b.dtype} on {b.device}, "
                         f"blocks are {Ci.dtype} on {Ci.device}")
    if Ci.device.type == "cpu":
        return xla_tridiag_solve_inv(Ci, Ek, b)
    if not b.is_contiguous():
        raise ValueError("tridiag_solve: a CUDA b must be contiguous")
    check_ieee(Ci.dtype, Ci.device)
    B, K, nb, _ = Ci.shape
    x = torch.empty_like(b)
    if B > 0 and K > 0 and nb > 0:
        with torch.cuda.device(Ci.device):
            err = _build.entry("op_tridiag_solve", Ci.dtype)(
                Ci.data_ptr(), Ek.data_ptr(), b.data_ptr(), x.data_ptr(),
                B, K, nb, _build.stream_ptr(Ci))
        _build.check(err, "tridiag_solve")
        LAUNCHES["tridiag_solve"] += 1
    return x
