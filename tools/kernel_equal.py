#!/usr/bin/env python3
"""Hold K3 of this tree value for value against K3 of another checkout.

K3 (`ops/cholesky.py:pallas_tri_inv_gram`, M = L^-T L^-1) feeds every
backsolve of the dense path, and the f32 bench trajectory is sensitive to
the last bit of M, so a redesign of its kernels must return the earlier M
bit for bit.  On a machine with a CUDA card:

    mkdir -p _parent && git archive <commit> onephase_tpu_torch | tar -x -C _parent
    python3 tools/kernel_equal.py --parent _parent

The other checkout's `onephase_tpu_torch` is imported under another name
(its kernels build into its own `build/`).  Both packages' wrappers run on
the same L, the factor of a seeded SPD matrix by this tree's `pallas_chol`:
f32 and f64, n from 1 to 2048 across the 32- and 64-wide tile edges,
B in {1, 2, 3, 16, 64}, and ill-conditioned Q (condition number 1e6 in f32,
1e12 in f64).  Each case prints whether `torch.equal` holds and how many
entries differ.  Then both are timed in turns (other, this, this, other;
medians of CUDA-event times around each call) at the dense path's two
shapes in f32, and each kernel's device time is read from `torch.profiler`
(the mean over 20 calls, by kernel name): at n=256 a call's event time is
set by its wrapper's host work, the device times show the kernels alone.
The last line is one JSON object; the exit code is 1 if any case differs.
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
# (dtype, n, B, condition number of Q or None for A A^T + n I)
CASES = [(dt, n, B, None) for dt in ("float32", "float64")
         for n, B in ((1, 1), (31, 3), (32, 16), (33, 1), (63, 3), (64, 16),
                      (65, 64), (130, 3), (256, 16), (1024, 64), (2048, 2))]
CASES += [("float32", 256, 16, 1e6), ("float32", 130, 3, 1e6),
          ("float64", 256, 16, 1e12)]
TIMED = ((256, 16), (1024, 64))


def _load(root: Path, name: str):
    """`ops.cholesky` of the package `root/onephase_tpu_torch`, imported
    as `name`."""
    pkg = root / "onephase_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.cholesky")


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="directory holding the other checkout's "
                         "onephase_tpu_torch/")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_equal: no CUDA device; the kernels run only "
                         "on the GPU")
    sys.path.insert(0, str(ROOT))
    from onephase_tpu_torch.ops import cholesky as new
    old = _load(args.parent.resolve(), "parent_onephase_tpu_torch")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)

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
    for n, B in TIMED:
        L = new.pallas_chol(_spd(rng, B, n, None, torch.float32, dev))[0]
        t_old, t_new = _time_abba(lambda: old.pallas_tri_inv_gram(L),
                                  lambda: new.pallas_tri_inv_gram(L))
        d_old = _device_ms(lambda: old.pallas_tri_inv_gram(L))
        d_new = _device_ms(lambda: new.pallas_tri_inv_gram(L))
        timings.append(dict(n=n, B=B, dtype="float32", other_ms=t_old,
                            this_ms=t_new, other_device_ms=d_old,
                            this_device_ms=d_new))
        print(f"K3 f32 n={n} B={B}: other checkout {t_old:.4f} ms, this "
              f"tree {t_new:.4f} ms ({t_new / t_old:.3f}x); device ms by "
              f"kernel: other {d_old}, this {d_new}", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernel": "tri_inv_gram", "cases": len(results),
                      "differing_cases": differing, "timings": timings,
                      "card": card, "results": results}), flush=True)
    return 1 if differing else 0


if __name__ == "__main__":
    sys.exit(main())
