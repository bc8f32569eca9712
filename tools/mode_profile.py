#!/usr/bin/env python3
"""Time K1, K1's Gram mode, K2, K3, K7 and K5 in every matmul mode on the
card, split K2's, K7's and K5's time by phase, and time the library calls
beside them.

    python3 tools/mode_profile.py                   # this tree alone
    python3 tools/mode_profile.py --parent _parent  # and another checkout's
    python3 tools/mode_profile.py --only tridiag    # K7 and K5 alone
    python3 tools/mode_profile.py --only tri_inv    # K3's two halves alone
    python3 tools/mode_profile.py --only chol       # K2 alone, f32 and f64
    python3 tools/mode_profile.py --only launch     # K1's, K2's launch path

At chip_smoke.py's PREC_SHAPE (n 1024, m 512, B 64) and the bench QP's
shape (256, 128, 16), on the operands of chip_smoke.py's precision phase
(a shared Jc, w in 0.1 .. 10, H None; an SPD Q, its factor L and that
factor's inverse Li), each kernel runs in IEEE and in each of
`precision.CARD_MODES`.  With `--parent` both trees' wrappers run on the
same operands, timed in turns (other, this, this, other: medians of
CUDA-event times around each call); alone, this tree's median of REPS
calls.

K2's phase split comes from `ops/cholesky.py:chol_phases` (the library's
clocked copy of `csrc/chol.cu`, built with -DONEPHASE_CHOL_CLOCKS): thread 0
of every block stamps clock64() at each phase boundary, so a phase's share
is its cycles over the block's total, averaged over the blocks: the
diagonal tiles (chol_tile.cuh), the row solves, the panel's cross
products, the trailing update, and the rest (the copy of Q, the writes of
the diagonal block, the cluster barriers).  Each share times the kernel's
own time (the uninstrumented launch) gives the phase's milliseconds.  A
tree without the clocked entry point gets no split.

The yardsticks, one PyTorch call each on the same operands: `baddbmm` in
IEEE float32 and with cuBLAS's TF32 switch on, `baddbmm` on bf16 and fp16
operands with a float32 result where the installed torch takes
`out_dtype` (else null, with the reason), `linalg.cholesky_ex` and
`cholesky_inverse`.

K7 (`pallas_tridiag_factor`) and K5 (`pallas_tridiag_solve`) run at
chip_smoke.py's TRIDIAG_MODE_SHAPES (K 400, nb 32: the chain path's; K
204, nb 63: the banded path's), one instance of its kind of SPD band
(A_k = G G^T + 3 I, B_k ~ 0.3 N(0, 1), delta 1e-4), K5 on the IEEE
factor's Ci and Ek, in IEEE and every card mode, timed as above.  Their
phase split comes from `ops/tridiag_pallas.py:tridiag_phases` (the clocked
copy of their sources, -DONEPHASE_TRIDIAG_CLOCKS): K7's cp.async waits,
E E^T, the tile Cholesky and inverse, B_k Ci_k^T and the stores; K5's ring
waits, its first chain, the consumers' middle sync, its second chain and
the stage's handoff.

K3 alone (`--only tri_inv`) runs at PREC_SHAPE: its inverse
(`launch_tri_inv`), its Gram half (K1's `lower` mode) and the whole
(`pallas_tri_inv_gram`) in IEEE and every card mode, timed as above,
beside `cholesky_inverse`, and its inverse's phase split from
`ops/cholesky.py:tri_inv_phases` (the clocked copy of its sources,
-DONEPHASE_TRI_INV_CLOCKS): the slab loads, their stores to shared memory
(and, in a mode, their split) and the barriers; the update product; a
chunk's right-hand side and substitution; Li's stores; the rest.

K2 in float64 (with `--only chol`, K2 alone: IEEE float32, every card
mode and float64) runs at both dense shapes beside `cholesky_ex` in
float64, with its phase split from the same clocked copy
(`op_chol_clocks_f64`).

The launch path (`--only launch`, chip_smoke.py's `launch_path_cases`):
K1 at 256/128/16 and K2 at 256/16 and the scenario shapes, float32 and
float64, each tree's wrapper and the library call (`baddbmm`,
`cholesky_ex`) in turns, the wall time a call of 200 calls back to back
ended by one synchronize (chip_smoke.py's `host_call_ms`), beside the
kernel's device time from torch.profiler.

Prints one line a kernel and shape, then one JSON object (also written to
`--out`, when given).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
SHAPES = ((1024, 512, 64), (256, 128, 16))
TRIDIAG_SHAPES = ((400, 32), (204, 63))
REPS = 5


def _load(root: Path, name: str):
    """The package `root/onephase_tpu_torch`, imported as `name`."""
    if name not in sys.modules:
        pkg = root / "onephase_tpu_torch"
        spec = importlib.util.spec_from_file_location(
            name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return {m: importlib.import_module(f"{name}.ops.{m}")
            for m in ("schur", "cholesky", "precision", "_build",
                      "tridiag_pallas")}


def _event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _time(fns) -> list:
    """Medians of REPS rounds over `fns` in turns (a, b, b, a for two)."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    order = list(range(len(fns)))
    order = order + order[::-1]
    ts = [[] for _ in fns]
    for _ in range(REPS):
        for i in order:
            ts[i].append(_event_ms(fns[i]))
    return [float(np.median(t)) for t in ts]


def _spd(rng, B, n, dev):
    A = torch.as_tensor(rng.normal(size=(B, n, n)), dtype=torch.float64,
                        device=dev)
    Q = A @ A.mT / n + torch.eye(n, dtype=torch.float64, device=dev)
    return Q.float().contiguous()


def _operands(n, m, B, dev, mods):
    rng = np.random.default_rng(n + B)
    Jc = torch.as_tensor(rng.normal(size=(m, n)) / np.sqrt(n),
                         dtype=torch.float32, device=dev)
    w = torch.as_tensor(rng.uniform(0.1, 10.0, size=(B, m)),
                        dtype=torch.float32, device=dev)
    bnd = torch.as_tensor(rng.uniform(0.0, 5.0, size=(B, n)),
                          dtype=torch.float32, device=dev)
    Q = _spd(rng, B, n, dev)
    ch, prec = mods["cholesky"], mods["precision"]
    L = ch.pallas_chol(Q, mode=prec.IEEE)[0]
    Li = torch.empty_like(L)
    ch.launch_tri_inv(L, Li)
    return Jc, w, bnd, Q, L, Li


def profile_chol_f64(this, other, Q32) -> dict:
    """K2 in float64 on Q32 in float64: this tree's (and the other's, in
    turns) beside `cholesky_ex`, and each tree's phase split, the shares
    times the kernel's own time giving each phase's milliseconds."""
    Q = Q32.double()
    fns = [lambda: this["cholesky"].pallas_chol(Q)]
    if other is not None:
        fns = [lambda: other["cholesky"].pallas_chol(Q)] + fns
    fns.append(lambda: torch.linalg.cholesky_ex(Q))
    ts = _time(fns)
    res = {"ms": ts[-2], "cholesky_ex": ts[-1]}
    if other is not None:
        res["parent_ms"] = ts[0]
    n = Q.shape[-1]
    print(f"{Q.shape[0]}/{n} K2 float64 ms: {res['ms']:.4f}"
          + (f" (parent {res['parent_ms']:.4f})" if other else "")
          + f"; cholesky_ex {res['cholesky_ex']:.4f}", flush=True)
    for tree, mods in (("this", this), ("parent", other)):
        if mods is None:
            continue
        try:
            s = _phase_split(mods, Q, None)
        except ValueError:   # a tree whose split takes float32 alone
            s = None
        if s is None:
            continue
        ms = res["ms" if tree == "this" else "parent_ms"]
        s["ms"] = {p: v * ms for p, v in s["share"].items()}
        res.setdefault("phases", {})[tree] = s
        print(f"{Q.shape[0]}/{n} K2 float64 phases {tree}: " + ", ".join(
            f"{p} {v * 100:.1f}% {s['ms'][p]:.4f} ms"
            for p, v in s["share"].items())
            + f" (cluster {s['cluster']})", flush=True)
    return res


def profile_launch(this, other, dev) -> dict:
    """The launch path (chip_smoke.py's launch_path_cases): the wall time
    a call of each tree's wrapper and of the library call, in turns, and
    this tree's kernel's device time (torch.profiler)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    trees = {"this": (this["schur"], this["cholesky"])}
    if other is not None:
        trees["parent"] = (other["schur"], other["cholesky"])
    out = {}
    for case, fns, lib, kname, lib_op in chip_smoke.launch_path_cases(
            dev, trees):
        labels = list(fns)
        ts = chip_smoke.host_call_ms(*fns.values(), lib)
        row = {f"{k}_host_ms": t for k, t in zip(labels, ts)}
        row["library_host_ms"] = ts[-1]
        row["device_ms"] = chip_smoke._device_ms(fns["this"], kname)
        row["library_device_ms"] = chip_smoke._device_ms(lib, lib_op)
        out[case] = row
        print(f"launch {case}: " + "; ".join(
            f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    return out


def _kernels(mods, ops):
    """{name: fn(mode)} of one tree's wrappers on the operands."""
    Jc, w, bnd, Q, L, Li = ops
    sc, ch = mods["schur"], mods["cholesky"]

    def gram(md):
        G = torch.empty_like(Li)
        sc.launch_fused_q(Li, None, None, None, G, lower=True, mode=md)
        return G

    return {"fused_q": lambda md: sc.pallas_fused_q(Jc, w, None, bnd,
                                                     mode=md),
            "fused_q_lower": gram,
            "chol": lambda md: ch.pallas_chol(Q, mode=md),
            "tri_inv_gram": lambda md: ch.pallas_tri_inv_gram(L, mode=md)}


def _modes(prec):
    """This tree's IEEE and card modes, by name."""
    return [prec.IEEE] + list(prec.CARD_MODES)


def _phase_split(mods, Q, md) -> dict | None:
    """K2's phase shares (ops/cholesky.py:chol_phases), or None for a tree
    without the clocked entry point."""
    fn = getattr(mods["cholesky"], "chol_phases", None)
    return None if fn is None else fn(Q, md)


def _yardsticks(ops, n, m, B) -> dict:
    Jc, w, bnd, Q, L, _ = ops
    Hb = torch.diag_embed(bnd)
    A = (Jc.mT[None] * w[:, None, :]).contiguous()
    Jb = Jc.expand(B, m, n).contiguous()
    saved = torch.backends.cuda.matmul.allow_tf32
    out = {}

    def tf32():
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.baddbmm(Hb, A, Jb)
        torch.backends.cuda.matmul.allow_tf32 = saved

    out["baddbmm_ieee"], out["baddbmm_tf32"] = _time(
        [lambda: torch.baddbmm(Hb, A, Jb), tf32])
    for name, dt in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        a, b = A.to(dt), Jb.to(dt)
        try:
            torch.baddbmm(Hb, a, b, out_dtype=torch.float32)
        except (TypeError, RuntimeError) as e:
            out[f"baddbmm_{name}"] = None
            out[f"baddbmm_{name}_reason"] = str(e).splitlines()[0][:160]
            continue
        out[f"baddbmm_{name}"] = _time(
            [lambda: torch.baddbmm(Hb, a, b, out_dtype=torch.float32)])[0]
    out["cholesky_ex"] = _time([lambda: torch.linalg.cholesky_ex(Q)])[0]
    out["cholesky_inverse"] = _time([lambda: torch.cholesky_inverse(L)])[0]
    return out


def _tridiag_operands(K, nb, dev, mods):
    """One instance of chip_smoke.py's kind of SPD band, delta, a
    right-hand side, and the IEEE factor's Ci and Ek."""
    rng = np.random.default_rng(K + nb)
    G = rng.normal(size=(1, K, nb, nb))
    Ad = torch.as_tensor(G @ G.transpose(0, 1, 3, 2) + 3.0 * np.eye(nb),
                         dtype=torch.float32, device=dev)
    Bs = torch.as_tensor(rng.normal(size=(1, K - 1, nb, nb)) * 0.3,
                         dtype=torch.float32, device=dev)
    b = torch.as_tensor(rng.normal(size=(1, K, nb)), dtype=torch.float32,
                        device=dev)
    _, Ci, Ek, _ = mods["tridiag_pallas"].pallas_tridiag_factor(
        Ad, Bs, 1e-4, mode=mods["precision"].IEEE)
    return Ad, Bs, b, Ci, Ek


def _tridiag_kernels(mods, ops):
    Ad, Bs, b, Ci, Ek = ops
    tp = mods["tridiag_pallas"]
    return {"tridiag_factor":
                lambda md: tp.pallas_tridiag_factor(Ad, Bs, 1e-4, mode=md),
            "tridiag_solve":
                lambda md: tp.pallas_tridiag_solve(Ci, Ek, b, mode=md)}


def _tridiag_split(mods, ops, md) -> dict | None:
    """K7's and K5's phase shares (tridiag_phases), or None for a tree
    without the clocked entry points."""
    fn = getattr(mods["tridiag_pallas"], "tridiag_phases", None)
    Ad, Bs, b, _, _ = ops
    return None if fn is None else fn(Ad, Bs, 1e-4, b, md)


def _time_rows(mine, theirs, this, other) -> dict:
    """{kernel: {mode: {"ms", "parent_ms"?}}} over IEEE and the card modes,
    in turns with the other tree's wrappers where given."""
    out = {}
    for kname, fn in mine.items():
        row = {}
        for md in _modes(this["precision"]):
            if theirs:
                omd = other["precision"].Mode(md.kind, md.passes)
                t_other, t_this = _time([lambda: theirs[kname](omd),
                                         lambda: fn(md)])
                row[str(md)] = {"ms": t_this, "parent_ms": t_other}
            else:
                row[str(md)] = {"ms": _time([lambda: fn(md)])[0]}
        out[kname] = row
    return out


def _print_rows(key, rows):
    for kname, row in rows.items():
        print(f"{key} {kname} ms: " + "; ".join(
            f"{k} {v['ms']:.4f}" + (f" (parent {v['parent_ms']:.4f})"
                                    if "parent_ms" in v else "")
            for k, v in row.items()), flush=True)


def profile_tridiag(this, other, dev) -> dict:
    """K7 and K5 at TRIDIAG_SHAPES: times in every mode (in turns with the
    other tree's where given) and each tree's phase split, the shares
    times the kernel's own time giving each phase's milliseconds."""
    report = {}
    for K, nb in TRIDIAG_SHAPES:
        ops = _tridiag_operands(K, nb, dev, this)
        key = f"K={K}/nb={nb}"
        res = _time_rows(_tridiag_kernels(this, ops),
                         _tridiag_kernels(other, ops) if other else None,
                         this, other)
        _print_rows(key, res)
        split = {}
        for md in _modes(this["precision"]):
            for tree, mods in (("this", this), ("parent", other)):
                if mods is None:
                    continue
                omd = mods["precision"].Mode(md.kind, md.passes)
                s = _tridiag_split(mods, ops, omd)
                if s is None:
                    continue
                for kernel, name in (("factor", "tridiag_factor"),
                                     ("solve", "tridiag_solve")):
                    ms = res[name][str(md)]["ms" if tree == "this"
                                            else "parent_ms"]
                    sk = s[kernel]
                    sk["ms"] = {p: v * ms for p, v in sk["share"].items()}
                    split.setdefault(tree, {}).setdefault(
                        kernel, {})[str(md)] = sk
                    print(f"{key} {'K7' if kernel == 'factor' else 'K5'} "
                          f"phases {tree} {md}: " + ", ".join(
                              f"{p} {v * 100:.1f}% {sk['ms'][p]:.4f} ms"
                              for p, v in sk["share"].items())
                          + f" ({sk['cycles']:.0f} cycles)", flush=True)
        res["phases"] = split
        report[key] = res
    return report


def _tri_inv_kernels(mods, ops):
    """K3's inverse, its Gram half and the whole, as {name: fn(mode)}."""
    _, _, _, _, L, Li = ops
    sc, ch = mods["schur"], mods["cholesky"]
    X, G = torch.empty_like(L), torch.empty_like(L)
    return {"tri_inv": lambda md: ch.launch_tri_inv(L, X, md),
            "gram": lambda md: sc.launch_fused_q(Li, None, None, None, G,
                                                 lower=True, mode=md),
            "tri_inv_gram": lambda md: ch.pallas_tri_inv_gram(L, mode=md)}


def profile_tri_inv(this, other, dev) -> dict:
    """K3 at SHAPES[0]: its halves and the whole in every mode (in turns
    with the other tree's where given), `cholesky_inverse`, and each
    tree's phase split of the inverse, the shares times the inverse's own
    time giving each phase's milliseconds."""
    n, m, B = SHAPES[0]
    ops = _operands(n, m, B, dev, this)
    key = f"{n}/{B}"
    L = ops[4]
    res = {"cholesky_inverse":
           _time([lambda: torch.cholesky_inverse(L)])[0]}
    print(f"{key} cholesky_inverse {res['cholesky_inverse']:.4f} ms",
          flush=True)
    res.update(_time_rows(_tri_inv_kernels(this, ops),
                          _tri_inv_kernels(other, ops) if other else None,
                          this, other))
    _print_rows(key, {k: v for k, v in res.items() if isinstance(v, dict)})
    split = {}
    for md in _modes(this["precision"]):
        for tree, mods in (("this", this), ("parent", other)):
            fn = getattr(mods["cholesky"], "tri_inv_phases", None) \
                if mods is not None else None
            if fn is None:
                continue
            s = fn(L, mods["precision"].Mode(md.kind, md.passes))
            ms = res["tri_inv"][str(md)]["ms" if tree == "this"
                                         else "parent_ms"]
            s["ms"] = {p: v * ms for p, v in s["share"].items()}
            split.setdefault(tree, {})[str(md)] = s
            print(f"{key} K3 inverse phases {tree} {md}: " + ", ".join(
                f"{p} {v * 100:.1f}% {s['ms'][p]:.4f} ms"
                for p, v in s["share"].items())
                + f" ({s['cycles']:.0f} cycles a block)", flush=True)
    res["phases"] = split
    return {key: res}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="directory holding another checkout's "
                         "onephase_tpu_torch/, timed in turns with this one")
    ap.add_argument("--out", type=Path,
                    help="also write the JSON report to this file")
    ap.add_argument("--only", choices=("dense", "tridiag", "tri_inv",
                                       "chol", "launch"),
                    help="profile K1-K3 (dense), K7/K5 (tridiag), K3's "
                         "halves with its inverse's phases (tri_inv), K2 "
                         "(chol) or K1's and K2's launch path (launch) "
                         "alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mode_profile: no CUDA device; the kernels run only "
                         "on the GPU")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    sys.path.insert(0, str(ROOT))
    this = {m: importlib.import_module(f"onephase_tpu_torch.ops.{m}")
            for m in ("schur", "cholesky", "precision", "_build",
                      "tridiag_pallas")}
    this["_build"].library()
    other = None
    if args.parent is not None:
        other = _load(args.parent.resolve(), "parent_onephase_tpu_torch")
        other["_build"].library()
    report = {"card": card, "shapes": {}}
    if args.only == "tri_inv":
        report["tri_inv"] = profile_tri_inv(this, other, dev)
    if args.only in (None, "tridiag"):
        report["tridiag"] = profile_tridiag(this, other, dev)
    if args.only in (None, "launch"):
        report["launch"] = profile_launch(this, other, dev)
    for n, m, B in SHAPES if args.only in (None, "dense", "chol") else ():
        ops = _operands(n, m, B, dev, this)
        key = f"{n}/{m}/{B}"
        res = {"yardsticks": _yardsticks(ops, n, m, B)
               if args.only != "chol" else
               {"cholesky_ex": _time([lambda: torch.linalg.cholesky_ex(
                   ops[3])])[0]}}
        print(f"{key} yardsticks (ms): {json.dumps(res['yardsticks'])}",
              flush=True)
        keep = (lambda k: k == "chol") if args.only == "chol" else \
            (lambda k: True)
        rows = _time_rows(
            {k: f for k, f in _kernels(this, ops).items() if keep(k)},
            {k: f for k, f in _kernels(other, ops).items() if keep(k)}
            if other else None, this, other)
        _print_rows(key, rows)
        res.update(rows)
        split = {}
        for md in _modes(this["precision"]):
            for tree, mods in (("this", this), ("parent", other)):
                if mods is None:
                    continue
                omd = mods["precision"].Mode(md.kind, md.passes)
                s = _phase_split(mods, ops[3], omd)
                if s is None:
                    continue
                ms = res["chol"][str(md)]["ms" if tree == "this"
                                          else "parent_ms"]
                s["ms"] = {p: v * ms for p, v in s["share"].items()}
                split.setdefault(tree, {})[str(md)] = s
                print(f"{key} K2 phases {tree} {md}: " + ", ".join(
                    f"{p} {v * 100:.1f}% {s['ms'][p]:.4f} ms"
                    for p, v in s["share"].items())
                    + f" (cluster {s['cluster']})", flush=True)
        res["chol_phases"] = split
        res["chol_f64"] = profile_chol_f64(this, other, ops[3])
        report["shapes"][key] = res
        del ops
        torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print(f"card: {card}", flush=True)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
