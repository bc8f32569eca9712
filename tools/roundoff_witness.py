#!/usr/bin/env python3
"""Two round-off witnesses of the multi-device layer, on a CUDA card.

`--part tax`: tax_grouped(G, na_g=8, wage_spread="banded") in float64
through ScenarioKernel (the dry run's blk leg, unsharded, with its
options) on the `pallas` lane (K2 factors the scenario blocks and the
border) and on `xla` (`cholesky_ex`), for each G of `--groups`.  On G =
`--probe-g` the `pallas` run also factors every K2 input with
`cholesky_ex` (its result unused): per factorization, max |L_K2 - L_ex| /
max |L_ex| over the blocks both factor, and the pivot flags that
disagree.  The two lanes' mu traces give the first outer iteration where
they differ.  Then the `xla` lane again, each factor input perturbed by a
seeded symmetric relative 1e-15 (`--perturb-seeds`): whether `xla`
itself leaves Optimal under a perturbation of K2's size.

`--part batch`: which operation makes a dense batch's rows depend on the
batch size.  The float32 bench (256/128, B=16, `pallas`) and the mixed
phase's float64 QP (1024/512, B=16) are stepped one outer iteration at a
time (`recheck_f64` after each, as `BatchSolver.solve` does) at B=16 and
on rows 0:8 alone at B=8.  At the first step whose rows differ, that step
is run again on both under a dispatch mode that fingerprints the rows
0:8 of every operation's inputs and outputs: the first operation whose
inputs agree and outputs differ is named (a PyTorch operation), or the
first whose inputs differ without an operation having made them differ
(a hand kernel, launched outside the dispatcher).  K1, K2 and K3 are
also run on seeded operands at B=16 and on rows 0:8 at B=8.

    python3 tools/roundoff_witness.py --part tax
    python3 tools/roundoff_witness.py --part batch

Prints one line per finding and a JSON line per part.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs                                    # noqa: E402
from onephase_tpu_torch import dryrun                      # noqa: E402
from onephase_tpu_torch.config import Params               # noqa: E402
from onephase_tpu_torch.ipm.history import IDX             # noqa: E402
from onephase_tpu_torch.ipm.state import RUNNING, STATUS_NAMES  # noqa: E402
from onephase_tpu_torch.ops import block_schur             # noqa: E402


# ----------------------------------------------------------------------
# tax_grouped on both lanes
def _tax_run(dev, G, lane, hist=2):
    from onephase_tpu_torch.models.tax import tax_grouped
    from onephase_tpu_torch.parallel.scenario import ScenarioKernel
    pars = Params().with_overrides(dict(
        dryrun.DRYRUN_OPTIONS, **{"term.max_it": 160, "chunk_size": 40,
                                  "history_capacity": hist,
                                  "kkt.linear_solver_type": lane}))
    k = ScenarioKernel(tax_grouped(G=G, na_g=8, wage_spread="banded",
                                   device=dev), pars, device=dev)
    t0 = time.perf_counter()
    st = k.initial_state()
    while int(st.status[0]) == RUNNING:
        st = k.run_chunk(st)
    torch.cuda.synchronize()
    return st, {"G": G, "lane": lane,
                "status": STATUS_NAMES[int(st.status[0])],
                "outer_its": int(st.t[0]) - 1,
                "cum_fac": int(st.cum_fac[0]),
                "seconds": time.perf_counter() - t0}


def _mu_trace(st):
    n = int(st.hist.count[0])
    return st.hist.buf[0, :n, IDX["mu"]].double().cpu().numpy()


def part_tax(dev, groups, probe_g, seeds):
    runs = []
    for G in groups:
        for lane in ("pallas", "xla"):
            _, r = _tax_run(dev, G, lane)
            runs.append(r)
            print(f"tax_grouped G={G} {lane}: {r['status']} in "
                  f"{r['outer_its']} outer its, {r['cum_fac']} "
                  f"factorizations, {r['seconds']:.2f} s", flush=True)

    # K2 against cholesky_ex on every input of the probe's pallas run
    k2, rec = block_schur.pallas_chol, []

    def k2_and_ex(M):
        L, d, ok = k2(M)
        Le, info = torch.linalg.cholesky_ex(M)
        both = ok & (info == 0)
        rel = float("nan")
        if bool(both.any()):
            num = (L - Le).abs().amax((-2, -1))[both]
            den = Le.abs().amax((-2, -1))[both]
            rel = float((num / den).max())
        rec.append({"shape": list(M.shape), "rel": rel,
                    "equal": bool(torch.equal(L[both], Le[both])),
                    "flags_differ": int((ok != (info == 0)).sum())})
        return L, d, ok

    block_schur.pallas_chol = k2_and_ex
    try:
        st_p, rp = _tax_run(dev, probe_g, "pallas", hist=200)
    finally:
        block_schur.pallas_chol = k2
    st_x, rx = _tax_run(dev, probe_g, "xla", hist=200)
    mu_p, mu_x = _mu_trace(st_p), _mu_trace(st_x)
    n = min(len(mu_p), len(mu_x))
    differ = np.nonzero(mu_p[:n] != mu_x[:n])[0]
    apart = np.nonzero(np.abs(mu_p[:n] - mu_x[:n])
                       > 1e-8 * np.abs(mu_x[:n]))[0]
    rels = [r["rel"] for r in rec if np.isfinite(r["rel"])]
    first_unequal = next((i for i, r in enumerate(rec) if not r["equal"]),
                         None)
    probe = {
        "G": probe_g, "pallas": rp, "xla": rx,
        "k2_calls": len(rec), "k2_rel_max": max(rels) if rels else None,
        "k2_rel_median": float(np.median(rels)) if rels else None,
        "k2_first_unequal_call": first_unequal,
        "k2_rel_first_calls": [r["rel"] for r in rec[:6]],
        "k2_flags_differ": sum(r["flags_differ"] for r in rec),
        "k2_shapes": sorted({tuple(r["shape"]) for r in rec}),
        "mu_first_unequal_it": int(differ[0]) + 1 if len(differ) else None,
        "mu_first_apart_1e-8_it": int(apart[0]) + 1 if len(apart) else None,
    }
    print(f"tax_grouped G={probe_g}: K2 against cholesky_ex over "
          f"{len(rec)} factor calls: max rel {probe['k2_rel_max']:.3e}, "
          f"median {probe['k2_rel_median']:.3e}, pivot flags differing "
          f"{probe['k2_flags_differ']}, first unequal call "
          f"{first_unequal}; mu traces: first unequal at outer it "
          f"{probe['mu_first_unequal_it']}, apart by 1e-8 at "
          f"{probe['mu_first_apart_1e-8_it']}", flush=True)

    # the xla lane under a perturbation of K2's size
    xla, perturbed = block_schur.xla_chol, []
    for seed in seeds:
        gen = torch.Generator(device=dev).manual_seed(seed)

        def xla_perturbed(M, gen=gen):
            R = torch.rand(M.shape, generator=gen, device=M.device,
                           dtype=M.dtype) * 2 - 1
            return xla(M + M * (R + R.mT) * 0.5e-15)

        block_schur.xla_chol = xla_perturbed
        try:
            _, r = _tax_run(dev, probe_g, "xla")
        finally:
            block_schur.xla_chol = xla
        r["perturb_seed"] = seed
        perturbed.append(r)
        print(f"tax_grouped G={probe_g} xla, factor inputs perturbed by "
              f"1e-15 (seed {seed}): {r['status']} in {r['outer_its']} "
              f"outer its, {r['cum_fac']} factorizations", flush=True)
    return {"runs": runs, "probe": probe, "xla_perturbed": perturbed}


# ----------------------------------------------------------------------
# batch-size dependence of a dense batch's rows
def _fingerprint(t, rows, batch, weights):
    """Two int64 sums of the bytes of rows 0:rows of a tensor whose
    leading dimension is the batch, or of a tensor with no batch
    dimension; None where the batch lies elsewhere."""
    if t.dim() >= 1 and t.shape[0] == batch:
        t = t[:rows]
    elif batch in t.shape:
        return None
    b = t.detach().reshape(-1).contiguous().view(torch.uint8).long()
    key = (b.numel(), str(t.device))
    if key not in weights:
        g = torch.Generator(device=t.device).manual_seed(b.numel())
        weights[key] = torch.randint(1, 2 ** 62, (2, b.numel()),
                                     generator=g, device=t.device)
    return (weights[key] * b).sum(-1)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _ptr(t):
    try:
        return t.untyped_storage().data_ptr()
    except RuntimeError:
        return None


def _tape_mode(rows, batch):
    """A dispatch mode logging, per operation: its name, its operands'
    shapes, the fingerprints of its inputs and outputs (an output that
    drops the batch of a batched input, a reduction over the batch, is
    not a row quantity: None) and their storages."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Tape(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.log, self.weights = [], {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            tin = [t for t in _tensors((args, kwargs)) if t.numel()]
            ins = [_fingerprint(t, rows, batch, self.weights) for t in tin]
            out = func(*args, **kwargs)
            tout = [t for t in _tensors(out) if t.numel()]
            batched = any(t.dim() and t.shape[0] == batch for t in tin)
            outs = [None if batched and not (t.dim() and t.shape[0] == batch)
                    else _fingerprint(t, rows, batch, self.weights)
                    for t in tout]
            self.log.append({"op": str(func),
                             "shapes": [list(t.shape) for t in tin],
                             "args": [repr(x) for x in args
                                      if not isinstance(x, torch.Tensor)],
                             "ins": ins, "outs": outs,
                             "in_ptrs": [_ptr(t) for t in tin],
                             "out_ptrs": [_ptr(t) for t in tout]})
            return out

    return Tape()


def _first_unequal(a, b):
    """Index of the first pair of fingerprints that differ (None where
    both are None or all agree)."""
    if len(a) != len(b):
        return 0
    for k, (x, y) in enumerate(zip(a, b)):
        if (x is None) != (y is None):
            return k
        if x is not None and not bool(torch.equal(x, y)):
            return k
    return None


def _producer(log, i, ptr):
    """The latest operation before #i that wrote storage `ptr`."""
    for j in range(i - 1, -1, -1):
        if ptr in log[j]["out_ptrs"]:
            return j
    return None


def _diff_tapes(big, small):
    """The first operation of the two tapes that departs (see the module
    docstring).  Where its inputs differ, the operation that wrote the
    differing input last is named: an allocation (`empty`) there means a
    hand kernel wrote it outside the dispatcher, a reduction over the
    batch that a quantity of the whole batch reached the rows."""
    for i, (a, b) in enumerate(zip(big.log, small.log)):
        if a["op"] != b["op"]:
            return {"op_index": i, "kind": "sequence", "op": a["op"],
                    "other_op": b["op"]}
        k = _first_unequal(a["ins"], b["ins"])
        if k is not None:
            j = _producer(big.log, i, a["in_ptrs"][k])
            return {"op_index": i, "kind": "inputs_differ", "op": a["op"],
                    "shapes": a["shapes"], "args": a["args"], "input": k,
                    "written_by_index": j,
                    "written_by": None if j is None else big.log[j]["op"],
                    "written_by_shapes": (None if j is None else
                                          big.log[j]["shapes"])}
        k = _first_unequal(a["outs"], b["outs"])
        if k is not None:
            return {"op_index": i, "kind": "outputs_differ", "op": a["op"],
                    "shapes": a["shapes"], "args": a["args"]}
    return {"op_index": None, "kind": "none found", "op": None,
            "ops": [len(big.log), len(small.log)]}


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_clone(v) for v in tree])
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree


def _rows_equal(big, small, rows):
    for a, b in zip(_tensors(big), _tensors(small)):
        if a.dim() and a.shape[0] != b.shape[0]:
            a = a[:rows]
        if a.shape != b.shape or not torch.equal(a, b):
            return False
    return True


def _state_tensors(st):
    return _tensors(tuple(st))


def _probe_config(dev, name, n, m, base, dtype, B=16, rows=8):
    from onephase_tpu_torch.models.qp import make_qp
    from onephase_tpu_torch.nlp import canonicalize
    from onephase_tpu_torch.parallel.batch import BatchSolver

    pars = Params().with_overrides(dict(
        base, **{"kkt.linear_solver_type": "pallas", "chunk_size": 1}))
    nlp = canonicalize(make_qp(n, m, seed=0, device=dev), dtype=dtype,
                       device=dev)
    x0s = np.random.default_rng(1).normal(size=(B, nlp.n)) * 0.1
    big, small = BatchSolver(nlp, pars), BatchSolver(nlp, pars)

    def step(solver, st):
        return solver.recheck_f64(solver.run_chunk(st))

    out = {"config": name, "first_unequal_step": None}
    sb, ss = big.init(x0s), small.init(x0s[:rows])
    if not _rows_equal(_state_tensors(sb), _state_tensors(ss), rows):
        out["first_unequal_step"] = 0
        prev = None
    else:
        for it in range(1, pars.term.max_it + 1):
            if not bool((ss.status == RUNNING).any()):
                break
            prev = (_clone(sb), _clone(ss))
            sb, ss = step(big, sb), step(small, ss)
            if not _rows_equal(_state_tensors(sb), _state_tensors(ss),
                               rows):
                out["first_unequal_step"] = it
                break
    if out["first_unequal_step"] is None:
        print(f"batch {name}: rows 0:{rows} at B={B} equal those solved at "
              f"B={rows} to the end", flush=True)
        return out
    tapes = []
    for solver, st0, bsz, x in ((big, prev and prev[0], B, x0s),
                                (small, prev and prev[1], rows,
                                 x0s[:rows])):
        tape = _tape_mode(rows, bsz)
        with tape:
            if st0 is None:
                solver.init(x)
            else:
                step(solver, st0)
        torch.cuda.synchronize()
        tapes.append(tape)
    out.update(_diff_tapes(*tapes))
    out["ops_taped"] = [len(t.log) for t in tapes]
    print(f"batch {name}: rows first unequal after step "
          f"{out['first_unequal_step']}; first departing operation "
          f"#{out['op_index']} {out['op']} ({out['kind']}), operand shapes "
          f"{out.get('shapes')}, arguments {out.get('args')}; its input {out.get('input')} written by "
          f"#{out.get('written_by_index')} {out.get('written_by')} "
          f"{out.get('written_by_shapes')}", flush=True)
    return out


def _kernels_batch_invariant(dev, B=16, rows=8):
    from onephase_tpu_torch.ops.cholesky import (pallas_chol,
                                                 pallas_tri_inv_gram)
    from onephase_tpu_torch.ops.schur import pallas_fused_q
    res = []
    for dtype, n, m in ((torch.float32, 256, 128),
                        (torch.float64, 1024, 512)):
        g = torch.Generator(device=dev).manual_seed(0)

        def r(*s):
            return torch.randn(*s, generator=g, device=dev, dtype=dtype)

        Jc, w = r(m, n), r(B, m).abs() + 0.1
        H, bnd = r(B, n, n), r(B, n).abs() + 1.0
        H = H @ H.mT / n
        Q = pallas_fused_q(Jc, w, H, bnd)
        Qs = pallas_fused_q(Jc, w[:rows], H[:rows], bnd[:rows])
        L, _, _ = pallas_chol(Q)
        Ls, _, _ = pallas_chol(Q[:rows].contiguous())
        M = pallas_tri_inv_gram(L)
        Ms = pallas_tri_inv_gram(L[:rows].contiguous())
        v = r(B, n)
        prod, prods = v @ Jc.T, v[:rows] @ Jc.T
        line = {"dtype": str(dtype), "n": n, "m": m,
                "K1_equal": bool(torch.equal(Q[:rows], Qs)),
                "K2_equal": bool(torch.equal(L[:rows], Ls)),
                "K3_equal": bool(torch.equal(M[:rows], Ms)),
                "shared_matmul_equal": bool(torch.equal(prod[:rows], prods)),
                "shared_matmul_rel": float((prod[:rows] - prods).abs().max()
                                           / prods.abs().max())}
        res.append(line)
        print(f"batch kernels {dtype} n={n} m={m}: rows 0:{rows} at B={B} "
              f"against B={rows}: " + ", ".join(
                  f"{k} {v}" for k, v in line.items()
                  if k not in ("dtype", "n", "m")), flush=True)
    return res


def part_batch(dev):
    return {"kernels": _kernels_batch_invariant(dev),
            "probes": [
                _probe_config(dev, "f32_bench", 256, 128, cs.BENCH_OPTIONS,
                              torch.float32),
                _probe_config(dev, "f64_mixed", 1024, 512, cs.MIXED_OPTIONS,
                              torch.float64)]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--part", choices=("tax", "batch"), required=True)
    ap.add_argument("--groups", type=int, nargs="*",
                    default=[8, 16, 24, 32, 64])
    ap.add_argument("--probe-g", type=int, default=16)
    ap.add_argument("--perturb-seeds", type=int, nargs="*",
                    default=[0, 1, 2, 3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("roundoff_witness.py needs a CUDA card")
    from onephase_tpu_torch.ops import _build
    _build.library()
    dev = torch.device("cuda")
    out = (part_tax(dev, args.groups, args.probe_g, args.perturb_seeds)
           if args.part == "tax" else part_batch(dev))
    print(json.dumps({"part": args.part, **out}, default=str), flush=True)


if __name__ == "__main__":
    main()
