"""Batched Cholesky + explicit-inverse solve operator M = L^-T L^-1.

The factorization is 35% of the reference's runtime and each factor feeds
~10 backsolves (docs/one-phase.tex:901-912).  As in the JAX package, the
`pallas` and `invchol` lanes turn an accepted factor into the explicit
inverse M, so every backsolve is one batched matvec.

Kernel wrappers of the `pallas` lane (CUDA tensors -> CUDA C++ kernel, CPU
tensors -> the plain version):

- `pallas_chol`: replaces onephase_tpu/ops/cholesky.py:pallas_chol
  (`_chol_kernel`, `_unblocked_chol`, `_tri_inv_unblocked`) with
  `csrc/chol.cu`.  Q (B, n, n) -> (L, d, ok).
- `pallas_tri_inv_gram`: replaces onephase_tpu/ops/cholesky.py:
  pallas_tri_inv_gram (`_tri_inv_gram_kernel`) with `csrc/tri_inv.cu`
  (the columns of L^-1) followed by the Gram product over the lower tile
  pairs, the kernel of `csrc/fused_q.cu` in its lower-triangular mode.
  L (B, n, n) -> M (B, n, n), symmetric bit for bit.
- `pallas_chol_inv`: the two in sequence (the JAX package's
  pallas_chol_inv).

Plain PyTorch versions: `xla_chol` (cholesky_ex + diag + ok),
`blocked_tri_inv` and `xla_chol_inv_from_L`.  The `xla`/`invchol` lanes
use these library ops, as the JAX package leaves those lanes to XLA.

Matmul modes (`Params.matmul_precision`, ops/precision.py): the wrappers
take `mode=` (default: the solve's scope) and launch the kernels' moded
variants for a non-IEEE float32 mode, every product of two entries of the
factor (K2) or of L and L^-1 (K3, and its Gram product) in the mode.
Their twins in a mode: `blocked_chol(Q, mode)` (cholesky_ex takes no
mode), `blocked_tri_inv(L, mode=)` and `xla_chol_inv_from_L(L, mode=)`.
"""

from __future__ import annotations

import torch

from . import _build
from . import count_launch
from . import precision
from .schur import launch_fused_q

_FLOATS = (torch.float32, torch.float64)


def xla_chol(Q):
    """(L, d, ok) by `torch.linalg.cholesky_ex`: ok (B,) bool is True where
    every pivot was positive (LAPACK's info == 0)."""
    L, info = torch.linalg.cholesky_ex(Q)
    return L, torch.diagonal(L, dim1=-2, dim2=-1), info == 0


def _check_square(t, name):
    if t.dim() != 3 or t.shape[-1] != t.shape[-2]:
        raise ValueError(f"{name}: expected a (B, n, n) batch, got "
                         f"{tuple(t.shape)}")
    if t.dtype not in _FLOATS:
        raise TypeError(f"{name}: dtype {t.dtype} is not float32/float64")
    if t.is_cuda:
        if not t.is_contiguous():
            raise ValueError(f"{name}: a CUDA input must be contiguous")
    elif not t.is_cpu:
        raise ValueError(f"{name}: no kernel for device {t.device}")


def blocked_chol(Q, mode, block: int = 64):
    """(L, d, ok) of a float32 batch Q with every product of two entries
    of the factor in matmul mode `mode`: K2's plain twin in a mode.  Panels
    of `block` columns, each column left-looking within its panel, then
    one trailing update a panel; the pivot protocol of K2
    (csrc/chol_tile.cuh): ok = every pivot > 0 and finite, a column scaled
    by 1 / sqrt(max(pivot, tiny)), L[j, j] = pivot times that.  Each entry
    of L is split once, when its column is final."""
    B, n = Q.shape[0], Q.shape[-1]
    tiny = 1e-38 if Q.dtype == torch.float32 else 1e-300
    big = torch.finfo(Q.dtype).max
    A = torch.tril(Q)
    L = torch.zeros_like(Q)
    parts = [torch.zeros_like(Q) for _ in range(mode.parts)]
    ok = torch.ones(B, dtype=torch.bool, device=Q.device)
    for k0 in range(0, n, block):
        k1 = min(n, k0 + block)
        for j in range(k0, k1):
            v = A[:, j:, j]
            if j > k0:
                v = v - precision.matmul_parts(
                    [p[:, j:, k0:j] for p in parts],
                    [p[:, j, k0:j, None] for p in parts], mode)[..., 0]
            piv = v[:, 0]
            ok = ok & (piv > 0) & (piv <= big)
            dinv = 1.0 / torch.sqrt(torch.where(piv > tiny, piv,
                                                piv.new_tensor(tiny)))
            col = v * dinv[:, None]
            L[:, j:, j] = col
            for p, part in zip(parts, precision.split(col, mode)):
                p[:, j:, j] = part
        if k1 < n:
            A[:, k1:, k1:] -= precision.matmul_parts(
                [p[:, k1:, k0:k1] for p in parts],
                [p[:, k1:, k0:k1].transpose(-1, -2) for p in parts], mode)
    return L, torch.diagonal(L, dim1=-2, dim2=-1), ok


def pallas_chol(Q, mode=None):
    """Batched Cholesky (L, d, ok): L lower with the strict upper triangle
    zeroed, d = diag(L), ok (B,) bool = every pivot positive and finite.
    On failure L is garbage and only ok matters.  In matmul mode `mode`
    (default: the current scope's; float32 only)."""
    _check_square(Q, "chol")
    mode = precision.kernel_mode(Q, mode)
    if Q.is_cpu:
        return xla_chol(Q) if mode.ieee else blocked_chol(Q, mode)
    B, n = Q.shape[0], Q.shape[-1]
    L = torch.empty_like(Q)
    d = Q.new_empty((B, n))
    # the kernel writes ok as one byte an instance, torch.bool's layout
    ok = Q.new_empty((B,), dtype=torch.bool)
    if B > 0 and n > 0:
        err = _build.launch("op_chol", Q, Q.data_ptr(), L.data_ptr(),
                            d.data_ptr(), ok.data_ptr(), B, n, mode.code)
        _build.check(err, "chol")
        count_launch("chol", mode)
    else:
        ok.fill_(True)
    return L, d, ok


# K2's phases, as the clocked copy of csrc/chol.cu stamps them
CHOL_PHASES = ("other", "diag", "solve", "cross", "trail")


def chol_phases(Q, mode=None):
    """Where K2's time goes on CUDA `Q` (float32 in matmul mode `mode`, or
    float64): one launch of the clocked copy of csrc/chol.cu
    (`_build.clock_library`, `op_chol_clocks_f32` / `op_chol_clocks_f64`,
    whose thread 0 of every block reads clock64() at each phase boundary).
    Returns {"share": {phase: cycles over the block's total, mean over the
    blocks}, "cluster": blocks an instance, "cycles": mean cycles a block}:
    the diagonal tiles, the row solves, the panel's cross products, the
    trailing update, and the rest (the copy of Q, the writes of the
    diagonal block, the cluster barriers).  A measurement: the solver never
    calls it."""
    _check_square(Q, "chol_phases")
    if Q.device.type != "cuda":
        raise ValueError("chol_phases: a CUDA batch")
    B, n = Q.shape[0], Q.shape[-1]
    L = torch.empty_like(Q)
    d = torch.empty(B, n, dtype=Q.dtype, device=Q.device)
    ok = torch.empty(B, dtype=torch.bool, device=Q.device)
    slots = len(CHOL_PHASES) + 2   # the phases, the total, the cluster size
    clk = torch.zeros(B * 8, 8, dtype=torch.int64, device=Q.device)
    fn = getattr(_build.clock_library(), "op_chol_clocks_" + (
        "f32" if Q.dtype == torch.float32 else "f64"))
    with torch.cuda.device(Q.device):
        err = fn(Q.data_ptr(), L.data_ptr(), d.data_ptr(), ok.data_ptr(), B,
                 n, precision.kernel_mode(Q, mode).code, clk.data_ptr(),
                 _build.stream_ptr(Q))
    _build.check(err, "chol_clocks")
    rows = clk[:, :slots]
    rows = rows[rows[:, len(CHOL_PHASES)] > 0].double().cpu()
    total = rows[:, len(CHOL_PHASES)]
    share = (rows[:, :len(CHOL_PHASES)] / total[:, None]).mean(0)
    return {"share": dict(zip(CHOL_PHASES, share.tolist())),
            "cluster": int(rows[0, len(CHOL_PHASES) + 1]),
            "cycles": float(total.mean())}


def _moded_tri_inv(L, mode, block: int = 32):
    """L^-1 with every product L[r, k] X[k, c] in matmul mode `mode`,
    by blocked forward substitution on the identity (the recurrence of
    K3's csrc/tri_inv.cu): each block of rows takes the product with the
    rows solved before it, then solves its own rows one by one; each row of
    X is split once, when it is final."""
    B, n = L.shape[0], L.shape[-1]
    Lp = precision.split(L, mode)
    X = torch.zeros_like(L)
    Xp = [torch.zeros_like(L) for _ in range(mode.parts)]
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        rhs = eye[r0:r1].expand(B, r1 - r0, n)
        if r0 > 0:
            rhs = rhs - precision.matmul_parts(
                [p[:, r0:r1, :r0] for p in Lp], [p[:, :r0] for p in Xp],
                mode)
        for r in range(r0, r1):
            x = rhs[:, r - r0]
            if r > r0:
                x = x - precision.matmul_parts(
                    [p[:, r, None, r0:r] for p in Lp],
                    [p[:, r0:r] for p in Xp], mode)[:, 0]
            x = x / L[:, r, r, None]
            X[:, r] = x
            for p, part in zip(Xp, precision.split(x, mode)):
                p[:, r] = part
    return X


def blocked_tri_inv(L, block: int = 256, mode=None):
    """L^-1 for a batch of lower-triangular L: invert the diagonal blocks
    (one batched triangular solve), then fill the strictly-lower block
    columns left to right with matmuls (port of the JAX package's
    blocked_tri_inv; same O(n^3/3) flops as solve_triangular(L, I)).
    `mode` None takes the current scope, whose products those matmuls are
    (the `xla`/`invchol` lanes); an IEEE Mode takes them in IEEE float32;
    a non-IEEE float32 Mode takes the substitution of `_moded_tri_inv`
    instead (K3's twin in that mode)."""
    if mode is None:
        return _plain_tri_inv(L, block)
    if not precision.kernel_mode(L, mode).ieee:
        return _moded_tri_inv(L, mode)
    with precision.ieee_products():
        return _plain_tri_inv(L, block)


def _plain_tri_inv(L, block):
    n = L.shape[-1]
    eye = torch.eye(n if n <= block else block, dtype=L.dtype,
                    device=L.device)
    if n <= block:
        return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    nb = -(-n // block)
    n_p = nb * block
    if n_p != n:
        Lp = torch.zeros(L.shape[:-2] + (n_p, n_p), dtype=L.dtype,
                         device=L.device)
        Lp[..., :n, :n] = L
        idx = torch.arange(n, n_p, device=L.device)
        Lp[..., idx, idx] = 1.0
        L = Lp
    diag = torch.stack([L[..., j * block:(j + 1) * block,
                          j * block:(j + 1) * block] for j in range(nb)],
                       dim=-3)
    dinv = torch.linalg.solve_triangular(diag, eye.expand_as(diag),
                                         upper=False)
    X = torch.zeros_like(L)
    for j in range(nb):
        X[..., j * block:(j + 1) * block,
          j * block:(j + 1) * block] = dinv[..., j, :, :]
    # left-looking fill: X[i,j] = -Dinv[i] @ L[i, j..i-1] @ X[j..i-1, j]
    for j in range(nb):
        c0, c1 = j * block, (j + 1) * block
        for i in range(j + 1, nb):
            r0, r1 = i * block, (i + 1) * block
            S = L[..., r0:r1, c0:r0] @ X[..., c0:r0, c0:c1]
            X[..., r0:r1, c0:c1] = -(dinv[..., i, :, :] @ S)
    return X[..., :n, :n] if n_p != n else X


def xla_chol_inv_from_L(L, mode=None):
    """M = L^-T L^-1 via blocked triangular inversion + a Gram matmul
    (`mode` as for `blocked_tri_inv`; a Mode: K3's twin in that mode)."""
    Li = blocked_tri_inv(L, mode=mode)
    return precision.twin_matmul(Li.transpose(-1, -2), Li, mode)


def launch_tri_inv(L, Li, mode=None):
    """Launch `csrc/tri_inv.cu`: Li = L^-1 for validated CUDA tensors, in
    matmul mode `mode` (None: the current scope's; float32; float64 runs
    IEEE)."""
    err = _build.launch("op_tri_inv", L, L.data_ptr(), Li.data_ptr(),
                        L.shape[0], L.shape[-1],
                        precision.kernel_mode(L, mode).code)
    _build.check(err, "tri_inv")


# K3's inverse's phases, as the clocked copy of csrc/tri_inv.cu stamps them
TRI_INV_PHASES = ("other", "load", "update", "solve", "store")


def tri_inv_phases(L, mode=None):
    """Where the time of K3's inverse goes on float32 CUDA `L` in matmul
    mode `mode`: one launch of the clocked copy of its kernels
    (`_build.clock_library("tri_inv")`, `op_tri_inv_clocks_f32`, whose
    thread 0 of every block, one of the substitution's threads, reads
    clock64() at each phase boundary).  Returns {"share": {phase: cycles
    over the block's total, mean over the blocks}, "cycles": mean cycles a
    block}: the slab loads, their stores to shared memory (a moded kernel:
    and their split) and the barriers; the update product; a chunk's
    right-hand side and its substitution; the stores of Li; the rest.  A
    measurement: the solver never calls it."""
    _check_square(L, "tri_inv_phases")
    if L.device.type != "cuda" or L.dtype != torch.float32:
        raise ValueError("tri_inv_phases: a float32 CUDA batch")
    B, n = L.shape[0], L.shape[-1]
    Li = torch.empty_like(L)
    k = len(TRI_INV_PHASES)
    clk = torch.zeros(B * -(-n // 64), 8, dtype=torch.int64, device=L.device)
    with torch.cuda.device(L.device):
        err = _build.clock_library("tri_inv").op_tri_inv_clocks_f32(
            L.data_ptr(), Li.data_ptr(), B, n,
            precision.kernel_mode(L, mode).code, clk.data_ptr(),
            _build.stream_ptr(L))
    _build.check(err, "tri_inv_clocks")
    rows = clk[:, :k + 1].double().cpu()
    rows = rows[rows[:, k] > 0]
    share = (rows[:, :k] / rows[:, k:]).mean(0)
    return {"share": dict(zip(TRI_INV_PHASES, share.tolist())),
            "cycles": float(rows[:, k].mean())}


def pallas_tri_inv_gram(L, mode=None):
    """M = (L L^T)^-1 = L^-T L^-1 for a batch of lower-triangular L (the
    strict upper triangle must be zero, as `pallas_chol` leaves it), in
    matmul mode `mode` (default: the current scope's)."""
    _check_square(L, "tri_inv_gram")
    mode = precision.kernel_mode(L, mode)
    if L.device.type == "cpu":
        return xla_chol_inv_from_L(L, mode)
    B, n = L.shape[0], L.shape[-1]
    Li = torch.empty_like(L)
    M = torch.empty_like(L)
    if B == 0 or n == 0:
        return M
    launch_tri_inv(L, Li, mode)
    launch_fused_q(Li, None, None, None, M, lower=True, mode=mode)
    count_launch("tri_inv_gram", mode)
    return M


def pallas_chol_inv(Q, mode=None):
    """(M, d, ok): explicit inverse of SPD Q plus the Cholesky pivot info."""
    L, d, ok = pallas_chol(Q, mode)
    return pallas_tri_inv_gram(L, mode), d, ok
