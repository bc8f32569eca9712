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
nb <= 32); the wrappers raise on larger blocks.

Matmul modes (`Params.matmul_precision`, ops/precision.py): the JAX
kernels' dots take no `precision`, so the knob reaches them.  The wrappers
take `mode=` (default: the solve's scope) and launch the kernels' moded
instantiations for a non-IEEE float32 mode (one a card mode, chosen by
the mode's code in csrc/tridiag_factor_mode.cu and
csrc/tridiag_solve_mode.cu), every product of two matrix entries in the
mode: E E^T and B_k Ci_k^T on the tensor cores and the block Cholesky and
inverse in K7, both matvec chains in K5; a code without an instantiation
is refused at launch (RuntimeError), never run as IEEE.  Their twins in a
mode (a non-IEEE Mode given to `xla_tridiag_factor_inv` or
`xla_tridiag_solve_inv`) run the same
recursions from K2's and K3's moded twins (`cholesky.blocked_chol`,
`cholesky._moded_tri_inv`) and `precision.matmul`, with E_k taken as the
product B_k Ci_k^T, as the JAX kernel takes it; `moded_factor_stage` is
one stage of the factor's.
"""

from __future__ import annotations

import operator
from functools import partial

import torch

from . import _build
from . import count_launch
from . import precision
from .block_tridiag import _delta_eye, tridiag_factor
from .cholesky import _moded_tri_inv, blocked_chol

_FLOATS = (torch.float32, torch.float64)
MAX_NB = 64


def block_inverses(Ck):
    """C_k^{-1} for every diagonal Cholesky block: one batched triangular
    solve against the identity (parallel over K)."""
    eye = torch.eye(Ck.shape[-1], dtype=Ck.dtype, device=Ck.device)
    return torch.linalg.solve_triangular(Ck, eye.expand_as(Ck), upper=False)


def _moded(t, mode) -> bool:
    """A non-IEEE Mode that reaches float32 `t` (None: the plain twin)."""
    return mode is not None and not precision.kernel_mode(t, mode).ieee


def xla_tridiag_factor_inv(Ad, Bs, delta, mode=None):
    """Plain version of the factor kernel: (Ck, Ci, Ek, ok).  `mode` None
    or IEEE: `tridiag_factor` + `block_inverses`; a non-IEEE float32 Mode:
    K7's recursion with every product in that mode (Ad (B, K, nb, nb))."""
    if _moded(Ad, mode):
        return _moded_factor_inv(Ad, Bs, delta, mode)
    f = tridiag_factor(Ad, Bs, delta)
    return f.Ck, block_inverses(f.Ck), f.Ek, f.ok


def moded_factor_stage(A, Bk, E_prev, delta, mode):
    """One stage of K7's recursion in `mode` on a batch of blocks (B, nb,
    nb): S = (A + delta I) - m(E_prev E_prev^T) (none where E_prev is
    None), C and its ok by `blocked_chol(S, mode)`, Ci = `_moded_tri_inv(C,
    mode)`, E = m(Bk Ci^T) (None where Bk is None); each m a product in
    `mode`.  Returns (C, Ci, E, ok)."""
    S = A + _delta_eye(A, delta)
    if E_prev is not None:
        S = S - precision.matmul(E_prev, E_prev.transpose(-1, -2), mode)
    C, _, ok = blocked_chol(S, mode)
    Ci = _moded_tri_inv(C, mode)
    E = (None if Bk is None
         else precision.matmul(Bk, Ci.transpose(-1, -2), mode))
    return C, Ci, E, ok


def _moded_factor_inv(Ad, Bs, delta, mode):
    """`moded_factor_stage` stage after stage, E_k carried."""
    K = Ad.shape[1]
    ok = torch.ones(Ad.shape[0], dtype=torch.bool, device=Ad.device)
    Cs, Cis, Es = [], [], []
    for k in range(K):
        C, Ci, E, ok_k = moded_factor_stage(
            Ad[:, k], Bs[:, k] if k < K - 1 else None,
            Es[-1] if Es else None, delta, mode)
        ok = ok & ok_k
        Cs.append(C)
        Cis.append(Ci)
        if E is not None:
            Es.append(E)
    Ek = torch.stack(Es, dim=1) if Es else torch.zeros_like(Bs)
    return torch.stack(Cs, dim=1), torch.stack(Cis, dim=1), Ek, ok


def xla_tridiag_solve_inv(Ci, Ek, b, mode=None):
    """Plain version of the solve kernel: the forward and backward matvec
    sweeps against the block inverses (`mode` a non-IEEE float32 Mode:
    every product in that mode)."""
    mm = (partial(precision.matmul, mode=mode) if _moded(Ci, mode)
          else operator.matmul)
    K = Ci.shape[-3]
    y = [mm(Ci[..., 0, :, :], b[..., 0, :, None])]
    for k in range(1, K):
        y.append(mm(Ci[..., k, :, :], b[..., k, :, None]
                    - mm(Ek[..., k - 1, :, :], y[-1])))
    x = [None] * K
    x[K - 1] = mm(Ci[..., K - 1, :, :].transpose(-1, -2), y[K - 1])
    for k in range(K - 2, -1, -1):
        x[k] = mm(Ci[..., k, :, :].transpose(-1, -2),
                  y[k] - mm(Ek[..., k, :, :].transpose(-1, -2), x[k + 1]))
    return torch.stack(x, dim=-3).squeeze(-1)


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


def pallas_tridiag_factor(Ad, Bs, delta, mode=None):
    """Factor tridiag(B, A + delta I, B^T): (Ck, Ci, Ek, ok) with the
    diagonal Cholesky blocks, their inverses, the subdiagonal blocks of L
    and ok (B,) bool = every pivot finite and > 0.  In matmul mode `mode`
    (default: the current scope's; float32 only)."""
    _check_band("tridiag_factor", Ad, Bs)
    mode = precision.kernel_mode(Ad, mode)
    if Ad.device.type == "cpu":
        return xla_tridiag_factor_inv(Ad, Bs, delta, mode)
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
                B, K, nb, mode.code, _build.stream_ptr(Ad))
        _build.check(err, "tridiag_factor")
        count_launch("tridiag_factor", mode)
    return Ck, Ci, Ek, ok != 0


def pallas_tridiag_solve(Ci, Ek, b, mode=None):
    """Solve L L^T x = b given the factor's block inverses Ci and the
    subdiagonal blocks Ek of L; b (B, K, nb).  In matmul mode `mode`
    (default: the current scope's; float32 only)."""
    _check_band("tridiag_solve", Ci, Ek)
    if tuple(b.shape) != tuple(Ci.shape[:3]):
        raise ValueError(f"tridiag_solve: b has shape {tuple(b.shape)}, "
                         f"expected {tuple(Ci.shape[:3])}")
    if b.dtype != Ci.dtype or b.device != Ci.device:
        raise ValueError(f"tridiag_solve: b is {b.dtype} on {b.device}, "
                         f"blocks are {Ci.dtype} on {Ci.device}")
    mode = precision.kernel_mode(Ci, mode)
    if Ci.device.type == "cpu":
        return xla_tridiag_solve_inv(Ci, Ek, b, mode)
    if not b.is_contiguous():
        raise ValueError("tridiag_solve: a CUDA b must be contiguous")
    B, K, nb, _ = Ci.shape
    x = torch.empty_like(b)
    if B > 0 and K > 0 and nb > 0:
        with torch.cuda.device(Ci.device):
            err = _build.entry("op_tridiag_solve", Ci.dtype)(
                Ci.data_ptr(), Ek.data_ptr(), b.data_ptr(), x.data_ptr(),
                B, K, nb, mode.code, _build.stream_ptr(Ci))
        _build.check(err, "tridiag_solve")
        count_launch("tridiag_solve", mode)
    return x


# K7's and K5's phases, as the clocked copy of their sources stamps them
# (csrc/tridiag.cu TdPhase: the same six slots, named per kernel)
TRIDIAG_PHASES = {
    "factor": ("other", "wait", "eet", "tile", "bci", "store"),
    "solve": ("other", "wait", "chain1", "sync", "chain2", "handoff")}


def _clock_split(clk, names):
    """{"share": {phase: cycles over the block's total, mean over the
    blocks}, "cycles": mean cycles a block} from the clock rows."""
    rows = clk[:, :len(names) + 1].double().cpu()
    rows = rows[rows[:, len(names)] > 0]
    total = rows[:, len(names)]
    share = (rows[:, :len(names)] / total[:, None]).mean(0)
    return {"share": dict(zip(names, share.tolist())),
            "cycles": float(total.mean())}


def tridiag_phases(Ad, Bs, delta, b, mode=None):
    """Where K7's and K5's time goes on a float32 CUDA band in matmul mode
    `mode`: one launch each of the clocked copies (`_build.clock_library(
    "tridiag")`, whose thread 0 of every block reads clock64() at each
    phase boundary), K5 on the clocked K7's own Ci and Ek with right-hand
    side b (B, K, nb).  Returns {"factor": split, "solve": split}, each
    {"share": {phase: cycles over the block's total, mean over the blocks},
    "cycles": mean cycles a block}; the phases are TRIDIAG_PHASES': K7's
    cp.async waits, E E^T, the tile Cholesky and inverse, B_k Ci_k^T and
    the stores; K5's ring waits, its first chain (E v), the consumers'
    middle sync, its second chain (Ci r) and the stage's handoff.  A
    measurement: the solver never calls it."""
    _check_band("tridiag_phases", Ad, Bs)
    if Ad.device.type != "cuda" or Ad.dtype != torch.float32:
        raise ValueError("tridiag_phases: a float32 CUDA band")
    if tuple(b.shape) != tuple(Ad.shape[:3]) or b.dtype != Ad.dtype or \
            b.device != Ad.device or not b.is_contiguous():
        raise ValueError(f"tridiag_phases: b has shape {tuple(b.shape)}, "
                         f"expected a contiguous {tuple(Ad.shape[:3])}")
    code = precision.kernel_mode(Ad, mode).code
    B, K, nb, _ = Ad.shape
    lib = _build.clock_library("tridiag")
    dvec = torch.as_tensor(delta, dtype=Ad.dtype, device=Ad.device)
    dvec = dvec.expand(B).contiguous()
    Ck, Ci, Ek = torch.empty_like(Ad), torch.empty_like(Ad), \
        torch.empty_like(Bs)
    ok = torch.ones(B, dtype=torch.int32, device=Ad.device)
    x = torch.empty_like(b)
    out = {}
    for kernel, launch in (
            ("factor", lambda clk: lib.op_tridiag_factor_clocks_f32(
                Ad.data_ptr(), Bs.data_ptr(), dvec.data_ptr(),
                Ck.data_ptr(), Ci.data_ptr(), Ek.data_ptr(), ok.data_ptr(),
                B, K, nb, code, clk.data_ptr(), _build.stream_ptr(Ad))),
            ("solve", lambda clk: lib.op_tridiag_solve_clocks_f32(
                Ci.data_ptr(), Ek.data_ptr(), b.data_ptr(), x.data_ptr(),
                B, K, nb, code, clk.data_ptr(), _build.stream_ptr(Ad)))):
        clk = torch.zeros(B, 8, dtype=torch.int64, device=Ad.device)
        with torch.cuda.device(Ad.device):
            err = launch(clk)
        _build.check(err, f"tridiag_{kernel}_clocks")
        out[kernel] = _clock_split(clk, TRIDIAG_PHASES[kernel])
    return out
