#!/usr/bin/env python3
"""Hold K3, K1, K2, K6, K5 or K7 of this tree value for value against
another checkout's.

K3 (`ops/cholesky.py:pallas_tri_inv_gram`, M = L^-T L^-1) feeds every
backsolve of the dense path, K1 (`ops/schur.py:pallas_fused_q`, Q = H +
Jc^T diag(w) Jc + diag(bnd)) every factorization, and K5
(`ops/tridiag_pallas.py:pallas_tridiag_solve`) every backsolve of the chain
and banded paths; the f32 trajectories are sensitive to the last bit of M,
of the factor and of the step, so a redesign of any of them must return the
earlier values bit for bit.  On a machine with a CUDA card:

    mkdir -p _parent && git archive <commit> onephase_tpu_torch | tar -x -C _parent
    python3 tools/kernel_equal.py --parent _parent                         # K3
    python3 tools/kernel_equal.py --parent _parent --kernel fused_q        # K1
    python3 tools/kernel_equal.py --parent _parent --kernel chol           # K2
    python3 tools/kernel_equal.py --parent _parent --kernel fused_q_tri    # K6
    python3 tools/kernel_equal.py --parent _parent --kernel tridiag_solve  # K5
    python3 tools/kernel_equal.py --parent _parent --kernel tridiag_factor # K7
    python3 tools/kernel_equal.py --parent _parent --kernel chol_modes
    python3 tools/kernel_equal.py --parent _parent --kernel tridiag_factor_k1
    python3 tools/kernel_equal.py --parent _parent --kernel tri_inv_modes

The other checkout's `onephase_tpu_torch` is imported under another name
(its kernels build into its own `build/`).

`--kernel tri_inv_gram` (the default): both packages' wrappers run on the
same L, the factor of a seeded SPD matrix by this tree's `pallas_chol`:
f32 and f64, n from 1 to 2048 across the 32- and 64-wide tile edges,
B in {1, 2, 3, 16, 64}, and ill-conditioned Q (condition number 1e6 in f32,
1e12 in f64); `torch.equal` on the whole M.

`--kernel fused_q`: both wrappers run on the same seeded Jc, w, H, bnd:
f32 and f64, n from 1 to 2048 on both sides of the 64 and 128 tile edges,
m in {0, 1, 70, 128, 512, 1024}, B from 1 to 64, Jc and H shared (batch
stride 0) and per instance, H = None, and w spread over 1e-8 .. 1e8.  Only
the lower triangle and the diagonal are read on the path, so the check is
`torch.equal(tril(this), tril(other))`; the entries that differ above the
diagonal are counted and printed.  The rank-m part of this tree's Q (H =
None, bnd = 0) must also be bit-symmetric.

`--kernel chol`: both packages' `pallas_chol` on the same seeded Q, K3's
cases (f32 and f64, n from 1 to 2048, ill-conditioned Q) and a non-PD Q;
`torch.equal` on L, d and ok.

`--kernel fused_q_tri`: both packages' `pallas_fused_q_tri` on the same
operands: f32 and f64, n in {256, 1024, 2048} and ragged n, Jc and H
shared and per instance, H = None and an unsymmetric H; `torch.equal` on
the full Q, both triangles.

`--kernel tridiag_solve`: both packages' `pallas_tridiag_solve` on the
same Ci, Ek (this tree's factor of a seeded SPD band) and b: f32 and f64,
(B, K, nb) at the chain path's (1, 400, 32), the banded path's (1, 204, 63)
and (1, 200, 64), ragged (2, 7, 30), K = 1 (2, 1, 32) and more edges;
`torch.equal` on x.  This tree's K5 is also timed at B = 16 and 132 (one
block per instance: does B > 1 fill the card?).

`--kernel tridiag_factor`: both packages' `pallas_tridiag_factor` on the
same seeded SPD band (A_k = G G^T + 3 I, B_k ~ 0.3 N(0, 1)) and a per
instance delta: f32 and f64 at K5's (B, K, nb) cases, and a band with one
non-PD block; `torch.equal` on Ck, Ci, Ek and ok (a failed instance's
blocks are garbage and count only through ok).  Timed in turns, with
device times, at the chain's and the banded path's shapes.

`--kernel chol_modes`: both packages' `pallas_chol` in every card matmul
mode (`precision.CARD_MODES`) on chip_smoke.py's precision-phase Q (the
SPD Q of `_prec_kernels` at PREC_SHAPE, n 1024, B 64, and at the bench
QP's 256/16) and on smaller edges (n 1, 33, 65, 130); `torch.equal` on L,
d and ok.  For a change to the tile Cholesky that K2's moded panel shares
(csrc/chol_tile.cuh).  No timings.

`--kernel tridiag_factor_k1`: both packages' `pallas_tridiag_factor` at
K = 1 (no block product: the tile Cholesky and inverse alone) in every
card mode, B = 3, nb in {1, 5, 30, 32, 33, 63, 64}; `torch.equal` on Ck,
Ci and ok.  No timings.

`--kernel tri_inv_modes`: both packages' K3 inverse (`launch_tri_inv`) in
every card mode on the factor of chip_smoke.py's precision-phase Q (n
1024, B 64; the bench QP's 256/16) and at the chunk edges (n 1, 31, 33,
63, 65, 130), and on chip_smoke.py's one-product operands (n 256, B 4).
A redesign of the moded inverse may move its values (the order of its
sums): each case prints the entries that differ and the largest
difference relative to the largest entry, and holds each tree's inverse
to the recurrence of its mode, in float64 (chip_smoke.py's
`inverse_residual`: X[r, c] L[r, r] = delta_rc - sum_{k<r} m(L[r, k],
X[k, c])).  A case holds where this
tree's residual is at most 4x the other's (or 1e-7) and, on the
one-product operands, where the two trees agree bit for bit.  The whole
K3 (inverse and Gram) is timed in turns at n 1024 in every mode.  Unlike
the bit-for-bit checks, this one passes with values that moved: each mode
ends on a line with its differing entries over all cases and the largest
ratio of this tree's residual to the other's.

Each case prints whether its check holds and how many entries differ.
Then both are timed in turns (other, this, this, other; medians of
CUDA-event times around each call) at the paths' shapes, and each
kernel's device time is read from `torch.profiler` (the mean over 20
calls, by kernel name): at n=256 a call's event time is set by its
wrapper's host work, the device times show the kernels alone.  Each mode
ends on one JSON line; several modes (`--kernel fused_q tridiag_solve`)
run in turn in one process.  The exit code is 1 if any case differs.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
REPS = 20
# K3: (dtype, n, B, condition number of Q or None for A A^T + n I)
CASES = [(dt, n, B, None) for dt in ("float32", "float64")
         for n, B in ((1, 1), (31, 3), (32, 16), (33, 1), (63, 3), (64, 16),
                      (65, 64), (130, 3), (256, 16), (1024, 64), (2048, 2))]
CASES += [("float32", 256, 16, 1e6), ("float32", 130, 3, 1e6),
          ("float64", 256, 16, 1e12)]
# K3 timed at the dense path's two shapes, and in f64 at n=1024
TIMED = (("float32", 256, 16), ("float32", 1024, 64), ("float64", 1024, 64))
# K1: (n, m, B, Jc and H shared, with H, w spread over 1e-8 .. 1e8), each
# in f32 and f64: both tile edges and their ragged neighbours, the 16-byte
# and the one-element copy routes, the 64- and the 128-edge grid (B T
# against two blocks per SM), a ragged k tail, m = 0 and m > n
FQ_CASES = [
    (1, 0, 1, True, True, False), (1, 1, 3, False, True, False),
    (31, 70, 3, False, True, False), (63, 1, 2, True, False, False),
    (64, 128, 16, True, True, False), (65, 70, 64, False, True, False),
    (127, 128, 3, True, True, False), (128, 0, 2, False, True, False),
    (128, 70, 64, False, True, False), (129, 70, 5, True, False, False),
    (130, 70, 3, False, True, False), (256, 128, 16, True, True, False),
    (256, 512, 16, False, False, False), (258, 130, 64, False, True, False),
    (1000, 512, 16, True, True, False), (1024, 512, 64, True, True, False),
    (1024, 1024, 4, False, True, False), (1030, 70, 16, False, True, False),
    (2048, 1024, 16, True, True, False), (256, 128, 16, True, True, True),
    (1024, 512, 64, True, True, True)]
# the dense path's three shapes (n, m, B), in f32 and f64
FQ_TIMED = (("float32", 256, 128, 16), ("float32", 1024, 512, 64),
            ("float32", 2048, 1024, 16), ("float64", 256, 128, 16),
            ("float64", 1024, 512, 64), ("float64", 2048, 1024, 16))
# K6: (n, m, B, Jc and H shared, H: "sym", "unsym" or None), each in f32
# and f64: the dense shapes, ragged n on both tile edges, both grids
FQT_CASES = [
    (256, 128, 16, True, "sym"), (256, 128, 16, False, "unsym"),
    (1024, 512, 64, True, "sym"), (1024, 512, 64, True, "unsym"),
    (1024, 512, 4, False, "sym"), (2048, 1024, 16, True, "sym"),
    (130, 70, 3, False, "unsym"), (1000, 300, 16, True, None),
    (65, 1, 5, True, "sym"), (200, 300, 2, True, None)]
# K5: (B, K, nb) -- chip_smoke.py's chain, banded and ragged shapes first
TS_CASES = [(1, 400, 32), (1, 204, 63), (1, 200, 64), (2, 7, 30),
            (2, 1, 32), (3, 9, 1), (1, 17, 33), (4, 50, 32), (2, 12, 64),
            (1, 2, 63)]
TS_TIMED = ((1, 400, 32), (1, 204, 63))
TS_SCALING = ((16, 400, 32), (132, 400, 32))


def _load(root: Path, name: str, module: str):
    """`module` (e.g. `ops.cholesky`) of the package
    `root/onephase_tpu_torch`, imported as `name`."""
    if name not in sys.modules:
        pkg = root / "onephase_tpu_torch"
        spec = importlib.util.spec_from_file_location(
            name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.{module}")


def _spd(rng, B, n, cond, dtype, dev):
    """A A^T + n I, or U diag(s) U^T with s log-spaced from 1 to 1/cond and
    U orthogonal; formed on the card in float64 from a seeded generator."""
    A = torch.as_tensor(rng.normal(size=(B, n, n)), dtype=torch.float64,
                        device=dev)
    if cond is None:
        Q = A @ A.mT + n * torch.eye(n, dtype=torch.float64, device=dev)
    else:
        U = torch.linalg.qr(A)[0]
        s = torch.logspace(0.0, -np.log10(cond), n, dtype=torch.float64,
                           device=dev)
        Q = (U * s) @ U.mT
        Q = 0.5 * (Q + Q.mT)
    return Q.to(dtype).contiguous()


def _time_abba(f, g) -> tuple:
    """Medians of REPS rounds of f, g, g, f, each launch between two CUDA
    events: (f's, g's)."""
    f(), g()
    torch.cuda.synchronize()
    tf, tg = [], []
    for _ in range(REPS):
        for fn, ts in ((f, tf), (g, tg), (g, tg), (f, tf)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end))
    return float(np.median(tf)), float(np.median(tg))


def _device_ms(fn) -> dict:
    """Mean device time of each kernel `fn` launches, by kernel name, over
    REPS calls traced by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total", 0)
        name = re.search(r"(\w+_kernel)\b", ev.key)
        if total and name:
            out[name.group(1)] = total / ev.count / 1e3
    return out


def check_tri_inv_gram(parent: Path, dev):
    """K3 of both trees on the same L: (results, timings, differing)."""
    from onephase_tpu_torch.ops import cholesky as new
    old = _load(parent, "parent_onephase_tpu_torch", "ops.cholesky")
    rng = np.random.default_rng(3)
    differing, results = 0, []
    for dname, n, B, cond in CASES:
        dtype = getattr(torch, dname)
        Q = _spd(rng, B, n, cond, dtype, dev)
        L, _, ok = new.pallas_chol(Q)
        if not bool(ok.all()):
            raise RuntimeError(f"K2 rejected the SPD case {dname} n={n} "
                               f"B={B} cond={cond}")
        M_new = new.pallas_tri_inv_gram(L)
        M_old = old.pallas_tri_inv_gram(L)
        torch.cuda.synchronize()
        same = torch.equal(M_new, M_old)
        n_diff = int((M_new != M_old).sum())
        finite = bool(torch.isfinite(M_new).all())
        symmetric = torch.equal(M_new, M_new.mT)
        differing += not same
        results.append(dict(dtype=dname, n=n, B=B, cond=cond, equal=same,
                            differing_entries=n_diff, finite=finite,
                            symmetric=symmetric))
        print(f"K3 {dname} n={n} B={B} cond={cond}: torch.equal {same} "
              f"({n_diff} entries differ), finite {finite}, symmetric "
              f"{symmetric}", flush=True)

    timings = []
    for dname, n, B in TIMED:
        L = new.pallas_chol(_spd(rng, B, n, None, getattr(torch, dname),
                                 dev))[0]
        t_old, t_new = _time_abba(lambda: old.pallas_tri_inv_gram(L),
                                  lambda: new.pallas_tri_inv_gram(L))
        d_old = _device_ms(lambda: old.pallas_tri_inv_gram(L))
        d_new = _device_ms(lambda: new.pallas_tri_inv_gram(L))
        timings.append(dict(n=n, B=B, dtype=dname, other_ms=t_old,
                            this_ms=t_new, other_device_ms=d_old,
                            this_device_ms=d_new))
        print(f"K3 {dname} n={n} B={B}: other checkout {t_old:.4f} ms, this "
              f"tree {t_new:.4f} ms ({t_new / t_old:.3f}x); device ms by "
              f"kernel: other {d_old}, this {d_new}", flush=True)
    return results, timings, differing


def check_chol(parent: Path, dev):
    """K2 of both trees on the same Q: (results, timings, differing)."""
    from onephase_tpu_torch.ops import cholesky as new
    old = _load(parent, "parent_onephase_tpu_torch", "ops.cholesky")
    rng = np.random.default_rng(5)
    differing, results = 0, []
    cases = CASES + [("float32", 130, 4, "non-PD"), ("float64", 130, 4,
                                                     "non-PD")]
    for dname, n, B, cond in cases:
        dtype = getattr(torch, dname)
        if cond == "non-PD":
            Q = _spd(rng, B, n, None, dtype, dev) - 1e3 * n * torch.eye(
                n, dtype=dtype, device=dev)
        else:
            Q = _spd(rng, B, n, cond, dtype, dev)
        new_out, old_out = new.pallas_chol(Q), old.pallas_chol(Q)
        torch.cuda.synchronize()
        L_new, d_new, ok_new = new_out
        L_old, d_old, ok_old = old_out
        ok_same = torch.equal(ok_new, ok_old)
        # a failed factor is garbage: L and d count only where ok
        good = ok_new & ok_old
        same = ok_same and torch.equal(L_new[good], L_old[good]) and \
            torch.equal(d_new[good], d_old[good])
        n_diff = int((L_new[good] != L_old[good]).sum())
        differing += not same
        results.append(dict(dtype=dname, n=n, B=B, cond=cond, equal=same,
                            differing_entries=n_diff,
                            ok=int(ok_new.sum())))
        print(f"K2 {dname} n={n} B={B} cond={cond}: torch.equal {same} "
              f"({n_diff} entries differ), ok {int(ok_new.sum())}/{B} "
              f"(other {int(ok_old.sum())})", flush=True)

    timings = []
    for dname, n, B in TIMED:
        Q = _spd(rng, B, n, None, getattr(torch, dname), dev)
        t_old, t_new = _time_abba(lambda: old.pallas_chol(Q),
                                  lambda: new.pallas_chol(Q))
        timings.append(dict(n=n, B=B, dtype=dname, other_ms=t_old,
                            this_ms=t_new))
        print(f"K2 {dname} n={n} B={B}: other checkout {t_old:.4f} ms, this "
              f"tree {t_new:.4f} ms ({t_new / t_old:.3f}x)", flush=True)
    return results, timings, differing


def _fq_operands(rng, n, m, B, shared, with_h, spread, dtype, dev):
    """Seeded Jc, w, H, bnd of the dense path's scales (Jc ~ N(0, 1/n),
    w in [0.1, 10] or log-uniform over 1e-8 .. 1e8, H = A A^T + n I)."""
    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    Jc = t(rng.normal(size=(m, n) if shared else (B, m, n)) / np.sqrt(n))
    w = t(10.0 ** rng.uniform(-8.0, 8.0, size=(B, m)) if spread
          else rng.uniform(0.1, 10.0, size=(B, m)))
    H = None
    if with_h:
        H = _spd(rng, 1, n, None, dtype, dev)[0] if shared else \
            _spd(rng, B, n, None, dtype, dev)
    bnd = t(rng.uniform(0.0, 5.0, size=(B, n)))
    return Jc, w, H, bnd


def check_fused_q(parent: Path, dev):
    """K1 of both trees on the same operands: (results, timings,
    differing)."""
    from onephase_tpu_torch.ops import schur as new
    old = _load(parent, "parent_onephase_tpu_torch", "ops.schur")
    rng = np.random.default_rng(7)
    differing, results = 0, []
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        for n, m, B, shared, with_h, spread in FQ_CASES:
            Jc, w, H, bnd = _fq_operands(rng, n, m, B, shared, with_h, spread,
                                         dtype, dev)
            Q_new = new.pallas_fused_q(Jc, w, H, bnd)
            Q_old = old.pallas_fused_q(Jc, w, H, bnd)
            R = new.pallas_fused_q(Jc, w, None, torch.zeros_like(bnd))
            torch.cuda.synchronize()
            lo_new, lo_old = torch.tril(Q_new), torch.tril(Q_old)
            same = torch.equal(lo_new, lo_old)
            n_diff = int((lo_new != lo_old).sum())
            n_upper = int((Q_new != Q_old).sum()) - n_diff
            finite = bool(torch.isfinite(Q_new).all())
            symmetric = torch.equal(R, R.mT)
            ok = same and symmetric
            differing += not ok
            results.append(dict(
                dtype=dname, n=n, m=m, B=B, shared=shared, H=with_h,
                w_spread=spread, lower_equal=same,
                differing_lower_entries=n_diff,
                differing_upper_entries=n_upper, finite=finite,
                rank_m_symmetric=symmetric))
            print(f"K1 {dname} n={n} m={m} B={B} "
                  f"{'shared' if shared else 'batched'} "
                  f"{'H' if with_h else 'H=None'}"
                  f"{' w 1e-8..1e8' if spread else ''}: torch.equal on the "
                  f"lower triangle {same} ({n_diff} entries differ; above "
                  f"the diagonal {n_upper}), finite {finite}, rank-m part "
                  f"symmetric {symmetric}", flush=True)

    timings = []
    for dname, n, m, B in FQ_TIMED:
        Jc, w, H, bnd = _fq_operands(rng, n, m, B, True, True, False,
                                     getattr(torch, dname), dev)
        t_old, t_new = _time_abba(lambda: old.pallas_fused_q(Jc, w, H, bnd),
                                  lambda: new.pallas_fused_q(Jc, w, H, bnd))
        d_old = _device_ms(lambda: old.pallas_fused_q(Jc, w, H, bnd))
        d_new = _device_ms(lambda: new.pallas_fused_q(Jc, w, H, bnd))
        timings.append(dict(n=n, m=m, B=B, dtype=dname, other_ms=t_old,
                            this_ms=t_new, other_device_ms=d_old,
                            this_device_ms=d_new))
        print(f"K1 {dname} n={n} m={m} B={B}: other checkout {t_old:.4f} "
              f"ms, this tree {t_new:.4f} ms ({t_new / t_old:.3f}x); device "
              f"ms by kernel: other {d_old}, this {d_new}", flush=True)
    return results, timings, differing


def check_fused_q_tri(parent: Path, dev):
    """K6 of both trees on the same operands: (results, timings,
    differing)."""
    from onephase_tpu_torch.ops import schur as new
    old = _load(parent, "parent_onephase_tpu_torch", "ops.schur")
    rng = np.random.default_rng(13)
    differing, results = 0, []
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        for n, m, B, shared, hkind in FQT_CASES:
            Jc, w, H, bnd = _fq_operands(rng, n, m, B, shared,
                                         hkind is not None, False, dtype,
                                         dev)
            if hkind == "unsym":
                H = H + torch.as_tensor(rng.normal(size=tuple(H.shape)),
                                        dtype=dtype, device=dev)
            Q_new = new.pallas_fused_q_tri(Jc, w, H, bnd)
            Q_old = old.pallas_fused_q_tri(Jc, w, H, bnd)
            torch.cuda.synchronize()
            same = torch.equal(Q_new, Q_old)
            n_diff = int((Q_new != Q_old).sum())
            finite = bool(torch.isfinite(Q_new).all())
            differing += not same
            results.append(dict(dtype=dname, n=n, m=m, B=B, shared=shared,
                                H=hkind, equal=same, differing_entries=n_diff,
                                finite=finite))
            print(f"K6 {dname} n={n} m={m} B={B} "
                  f"{'shared' if shared else 'batched'} H={hkind}: "
                  f"torch.equal on the full Q {same} ({n_diff} entries "
                  f"differ), finite {finite}", flush=True)

    timings = []
    for dname, n, m, B in FQ_TIMED:
        Jc, w, H, bnd = _fq_operands(rng, n, m, B, True, True, False,
                                     getattr(torch, dname), dev)
        t_old, t_new = _time_abba(
            lambda: old.pallas_fused_q_tri(Jc, w, H, bnd),
            lambda: new.pallas_fused_q_tri(Jc, w, H, bnd))
        d_old = _device_ms(lambda: old.pallas_fused_q_tri(Jc, w, H, bnd))
        d_new = _device_ms(lambda: new.pallas_fused_q_tri(Jc, w, H, bnd))
        timings.append(dict(n=n, m=m, B=B, dtype=dname, other_ms=t_old,
                            this_ms=t_new, other_device_ms=d_old,
                            this_device_ms=d_new))
        print(f"K6 {dname} n={n} m={m} B={B}: other checkout {t_old:.4f} "
              f"ms, this tree {t_new:.4f} ms ({t_new / t_old:.3f}x); device "
              f"ms by kernel: other {d_old}, this {d_new}", flush=True)
    return results, timings, differing


def _ts_operands(rng, B, K, nb, dtype, dev):
    """Ci, Ek of this tree's factor of a seeded SPD band (A_k = G G^T + 3 I,
    B_k ~ 0.3 N(0, 1), delta 1e-4) and b ~ N(0, 1)."""
    from onephase_tpu_torch.ops import tridiag_pallas as tp
    G = rng.normal(size=(B, K, nb, nb))
    Ad = torch.as_tensor(G @ G.transpose(0, 1, 3, 2) + 3.0 * np.eye(nb),
                         dtype=dtype, device=dev)
    Bs = torch.as_tensor(rng.normal(size=(B, K - 1, nb, nb)) * 0.3,
                         dtype=dtype, device=dev)
    _, Ci, Ek, ok = tp.pallas_tridiag_factor(Ad, Bs, 1e-4)
    if not bool(ok.all()):
        raise RuntimeError(f"K7 rejected the SPD band B={B} K={K} nb={nb}")
    b = torch.as_tensor(rng.normal(size=(B, K, nb)), dtype=dtype, device=dev)
    return Ci, Ek, b


def check_tridiag_solve(parent: Path, dev):
    """K5 of both trees on the same Ci, Ek, b: (results, timings,
    differing)."""
    from onephase_tpu_torch.ops import tridiag_pallas as new
    old = _load(parent, "parent_onephase_tpu_torch", "ops.tridiag_pallas")
    rng = np.random.default_rng(17)
    differing, results = 0, []
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        for B, K, nb in TS_CASES:
            Ci, Ek, b = _ts_operands(rng, B, K, nb, dtype, dev)
            x_new = new.pallas_tridiag_solve(Ci, Ek, b)
            x_old = old.pallas_tridiag_solve(Ci, Ek, b)
            torch.cuda.synchronize()
            same = torch.equal(x_new, x_old)
            n_diff = int((x_new != x_old).sum())
            finite = bool(torch.isfinite(x_new).all())
            differing += not same
            results.append(dict(dtype=dname, B=B, K=K, nb=nb, equal=same,
                                differing_entries=n_diff, finite=finite))
            print(f"K5 {dname} B={B} K={K} nb={nb}: torch.equal on x {same} "
                  f"({n_diff} entries differ), finite {finite}", flush=True)

    timings = []
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        for B, K, nb in TS_TIMED:
            Ci, Ek, b = _ts_operands(rng, B, K, nb, dtype, dev)
            t_old, t_new = _time_abba(
                lambda: old.pallas_tridiag_solve(Ci, Ek, b),
                lambda: new.pallas_tridiag_solve(Ci, Ek, b))
            d_old = _device_ms(lambda: old.pallas_tridiag_solve(Ci, Ek, b))
            d_new = _device_ms(lambda: new.pallas_tridiag_solve(Ci, Ek, b))
            timings.append(dict(B=B, K=K, nb=nb, dtype=dname,
                                other_ms=t_old, this_ms=t_new,
                                other_device_ms=d_old, this_device_ms=d_new))
            print(f"K5 {dname} B={B} K={K} nb={nb}: other checkout "
                  f"{t_old:.4f} ms, this tree {t_new:.4f} ms "
                  f"({t_new / t_old:.3f}x); device ms by kernel: other "
                  f"{d_old}, this {d_new}", flush=True)
    for B, K, nb in TS_SCALING:
        Ci, Ek, b = _ts_operands(rng, B, K, nb, torch.float32, dev)
        d_new = _device_ms(lambda: new.pallas_tridiag_solve(Ci, Ek, b))
        timings.append(dict(B=B, K=K, nb=nb, dtype="float32",
                            this_device_ms=d_new))
        print(f"K5 float32 B={B} K={K} nb={nb}: this tree, device ms by "
              f"kernel {d_new}", flush=True)
    return results, timings, differing


def _band(rng, B, K, nb, dtype, dev):
    """A seeded SPD band (A_k = G G^T + 3 I, B_k ~ 0.3 N(0, 1)) and a delta
    per instance in [0, 1e-3]."""
    G = rng.normal(size=(B, K, nb, nb))
    Ad = torch.as_tensor(G @ G.transpose(0, 1, 3, 2) + 3.0 * np.eye(nb),
                         dtype=dtype, device=dev)
    Bs = torch.as_tensor(rng.normal(size=(B, K - 1, nb, nb)) * 0.3,
                         dtype=dtype, device=dev)
    delta = torch.as_tensor(rng.uniform(0.0, 1e-3, size=B), dtype=dtype,
                            device=dev)
    return Ad, Bs, delta


def check_tridiag_factor(parent: Path, dev):
    """K7 of both trees on the same band: (results, timings, differing)."""
    from onephase_tpu_torch.ops import tridiag_pallas as new
    old = _load(parent, "parent_onephase_tpu_torch", "ops.tridiag_pallas")
    rng = np.random.default_rng(19)
    differing, results = 0, []
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        # K5's cases, then a band whose instance 1 has a non-PD block
        for B, K, nb, non_pd in [c + (False,) for c in TS_CASES] + [
                (3, 8, 30, True)]:
            Ad, Bs, delta = _band(rng, B, K, nb, dtype, dev)
            if non_pd:
                Ad[1, 3] -= 50.0 * torch.eye(nb, dtype=dtype, device=dev)
            got, want = (new.pallas_tridiag_factor(Ad, Bs, delta),
                         old.pallas_tridiag_factor(Ad, Bs, delta))
            torch.cuda.synchronize()
            good = got[3] & want[3]
            same = torch.equal(got[3], want[3]) and all(
                torch.equal(g[good], w[good]) for g, w in zip(got[:3],
                                                              want[:3]))
            n_diff = sum(int((g[good] != w[good]).sum())
                         for g, w in zip(got[:3], want[:3]))
            differing += not same
            results.append(dict(dtype=dname, B=B, K=K, nb=nb, non_pd=non_pd,
                                equal=same, differing_entries=n_diff,
                                ok=int(got[3].sum())))
            print(f"K7 {dname} B={B} K={K} nb={nb}: torch.equal on Ck, Ci, "
                  f"Ek, ok {same} ({n_diff} entries differ), ok "
                  f"{int(got[3].sum())}/{B} (other {int(want[3].sum())})",
                  flush=True)

    timings = []
    for dname in ("float32", "float64"):
        dtype = getattr(torch, dname)
        for B, K, nb in TS_TIMED:
            Ad, Bs, delta = _band(rng, B, K, nb, dtype, dev)
            t_old, t_new = _time_abba(
                lambda: old.pallas_tridiag_factor(Ad, Bs, delta),
                lambda: new.pallas_tridiag_factor(Ad, Bs, delta))
            d_old = _device_ms(lambda: old.pallas_tridiag_factor(Ad, Bs,
                                                                 delta))
            d_new = _device_ms(lambda: new.pallas_tridiag_factor(Ad, Bs,
                                                                 delta))
            timings.append(dict(B=B, K=K, nb=nb, dtype=dname,
                                other_ms=t_old, this_ms=t_new,
                                other_device_ms=d_old, this_device_ms=d_new))
            print(f"K7 {dname} B={B} K={K} nb={nb}: other checkout "
                  f"{t_old:.4f} ms, this tree {t_new:.4f} ms "
                  f"({t_new / t_old:.3f}x); device ms by kernel: other "
                  f"{d_old}, this {d_new}", flush=True)
    return results, timings, differing


def _card_modes(old_prec):
    """(this tree's Mode, the other tree's) for every card mode."""
    from onephase_tpu_torch.ops import precision
    return [(m, old_prec.Mode(m.kind, m.passes))
            for m in precision.CARD_MODES]


def check_chol_modes(parent: Path, dev):
    """K2 of both trees in every card mode: (results, [], differing)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from onephase_tpu_torch.ops import cholesky as new
    old = _load(parent, "parent_onephase_tpu_torch", "ops.cholesky")
    old_prec = _load(parent, "parent_onephase_tpu_torch", "ops.precision")
    differing, results = 0, []
    for n, B in ((1024, 64), (256, 16), (1, 2), (33, 2), (65, 2), (130, 3)):
        # chip_smoke.py's _prec_kernels draws: Jc, w, bnd, then Q
        rng = np.random.default_rng(n + B)
        rng.normal(size=(n // 2, n))
        rng.uniform(0.1, 10.0, size=(B, n // 2))
        rng.uniform(0.0, 5.0, size=(B, n))
        Q = chip_smoke._spd(rng, B, n, torch.float32, dev)
        for md_new, md_old in _card_modes(old_prec):
            got, want = new.pallas_chol(Q, mode=md_new), old.pallas_chol(
                Q, mode=md_old)
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            n_diff = int((got[0] != want[0]).sum())
            differing += not same
            results.append(dict(n=n, B=B, mode=str(md_new), equal=same,
                                differing_entries=n_diff))
            print(f"K2 {md_new} n={n} B={B}: torch.equal on L, d, ok {same} "
                  f"({n_diff} entries differ)", flush=True)
    return results, [], differing


def check_tridiag_factor_k1(parent: Path, dev):
    """K7 of both trees at K = 1 in every card mode: (results, [],
    differing)."""
    from onephase_tpu_torch.ops import tridiag_pallas as new
    old = _load(parent, "parent_onephase_tpu_torch", "ops.tridiag_pallas")
    old_prec = _load(parent, "parent_onephase_tpu_torch", "ops.precision")
    rng = np.random.default_rng(23)
    differing, results = 0, []
    for nb in (1, 5, 30, 32, 33, 63, 64):
        Ad, Bs, delta = _band(rng, 3, 1, nb, torch.float32, dev)
        for md_new, md_old in _card_modes(old_prec):
            got = new.pallas_tridiag_factor(Ad, Bs, delta, mode=md_new)
            want = old.pallas_tridiag_factor(Ad, Bs, delta, mode=md_old)
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            n_diff = sum(int((g != w).sum()) for g, w in zip(got[:2],
                                                             want[:2]))
            differing += not same
            results.append(dict(nb=nb, mode=str(md_new), equal=same,
                                differing_entries=n_diff))
            print(f"K7 K=1 {md_new} nb={nb}: torch.equal on Ck, Ci, ok "
                  f"{same} ({n_diff} entries differ)", flush=True)
    return results, [], differing


def check_tri_inv_modes(parent: Path, dev):
    """K3's inverse of both trees in every card mode: (results, timings,
    differing)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from onephase_tpu_torch.ops import cholesky as new
    from onephase_tpu_torch.ops import precision
    old = _load(parent, "parent_onephase_tpu_torch", "ops.cholesky")
    old_prec = _load(parent, "parent_onephase_tpu_torch", "ops.precision")

    def inverse(mod, L, md):
        X = torch.empty_like(L)
        mod.launch_tri_inv(L, X, md)
        torch.cuda.synchronize()
        return X

    cases = []
    for n, B in ((1024, 64), (256, 16), (1, 2), (31, 2), (33, 2), (63, 2),
                 (65, 2), (130, 3)):
        # chip_smoke.py's _prec_kernels draws: Jc, w, bnd, then Q
        rng = np.random.default_rng(n + B)
        rng.normal(size=(n // 2, n))
        rng.uniform(0.1, 10.0, size=(B, n // 2))
        rng.uniform(0.0, 5.0, size=(B, n))
        Q = chip_smoke._spd(rng, B, n, torch.float32, dev)
        cases.append((f"n={n} B={B}",
                      new.pallas_chol(Q, mode=precision.IEEE)[0], False))
    cases.append(("one-product n=256 B=4",
                  chip_smoke.one_product_operands(4, 256, 5, dev)[1], True))
    differing, results = 0, []
    for label, L, exact in cases:
        for md_new, md_old in _card_modes(old_prec):
            X_new, X_old = inverse(new, L, md_new), inverse(old, L, md_old)
            n_diff = int((X_new != X_old).sum())
            rel = float((X_new.double() - X_old.double()).abs().max()
                        / X_old.double().abs().max())
            r_new = chip_smoke.inverse_residual(L, X_new, md_new)
            r_old = chip_smoke.inverse_residual(L, X_old, md_new)
            finite = bool(torch.isfinite(X_new).all())
            ok = finite and (n_diff == 0 if exact else
                             r_new <= max(4.0 * r_old, 1e-7))
            differing += not ok
            results.append(dict(case=label, mode=str(md_new), holds=ok,
                                differing_entries=n_diff, rel_diff=rel,
                                residual=r_new, other_residual=r_old,
                                finite=finite))
            print(f"K3 inverse {md_new} {label}: holds {ok} ({n_diff} "
                  f"entries differ, max {rel:.2e} of the largest; residual "
                  f"{r_new:.2e}, other checkout's {r_old:.2e})", flush=True)
            del X_new, X_old
    for md_new, _ in _card_modes(old_prec):
        rows = [r for r in results if r["mode"] == str(md_new)]
        ratio = max((r["residual"] / r["other_residual"]
                     if r["other_residual"] > 0 else
                     (1.0 if r["residual"] == 0 else float("inf")))
                    for r in rows)
        print(f"K3 inverse {md_new}: "
              f"{sum(r['differing_entries'] for r in rows)} entries differ "
              f"in {sum(r['differing_entries'] > 0 for r in rows)} of "
              f"{len(rows)} cases; residual at most {ratio:.3f}x the other "
              f"checkout's", flush=True)
    timings = []
    L = cases[0][1]
    for md_new, md_old in _card_modes(old_prec):
        t_old, t_new = _time_abba(
            lambda: old.pallas_tri_inv_gram(L, mode=md_old),
            lambda: new.pallas_tri_inv_gram(L, mode=md_new))
        timings.append(dict(mode=str(md_new), n=1024, B=64, other_ms=t_old,
                            this_ms=t_new))
        print(f"K3 {md_new} n=1024 B=64: other checkout {t_old:.4f} ms, "
              f"this tree {t_new:.4f} ms ({t_new / t_old:.3f}x)", flush=True)
    return results, timings, differing


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="directory holding the other checkout's "
                         "onephase_tpu_torch/")
    ap.add_argument("--kernel", nargs="+", default=["tri_inv_gram"],
                    choices=("tri_inv_gram", "fused_q", "chol",
                             "fused_q_tri", "tridiag_solve",
                             "tridiag_factor", "chol_modes",
                             "tridiag_factor_k1", "tri_inv_modes"),
                    help="K3 (tri_inv_gram, the default), K1 (fused_q), K2 "
                         "(chol), K6 (fused_q_tri), K5 (tridiag_solve), K7 "
                         "(tridiag_factor), K2 in every card mode "
                         "(chol_modes), K7 at K = 1 in every card mode "
                         "(tridiag_factor_k1), K3's inverse in every card "
                         "mode (tri_inv_modes); several run in turn in one "
                         "process")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_equal: no CUDA device; the kernels run only "
                         "on the GPU")
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    checks = {"tri_inv_gram": check_tri_inv_gram,
              "fused_q": check_fused_q,
              "chol": check_chol,
              "fused_q_tri": check_fused_q_tri,
              "tridiag_solve": check_tridiag_solve,
              "tridiag_factor": check_tridiag_factor,
              "chol_modes": check_chol_modes,
              "tridiag_factor_k1": check_tridiag_factor_k1,
              "tri_inv_modes": check_tri_inv_modes}
    any_differ = False
    for kernel in args.kernel:
        results, timings, differing = checks[kernel](args.parent.resolve(),
                                                     dev)
        any_differ |= differing > 0
        print(f"card: {card}", flush=True)
        print(json.dumps({"kernel": kernel, "cases": len(results),
                          "differing_cases": differing, "timings": timings,
                          "card": card, "results": results}), flush=True)
    return 1 if any_differ else 0


if __name__ == "__main__":
    sys.exit(main())
