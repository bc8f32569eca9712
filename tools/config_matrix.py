#!/usr/bin/env python3
"""Solver-config x problem-class matrix of the port, on the card.

The port's counterpart of scripts/run_config_matrix_tpu.py, which ran the
JAX package's matrix on the TPU so that backend-lowering differences
(the bf16-matmul episode of its second round) would show on the real
hardware.  Here every cell runs the port: the script's nine configs
(KKT systems x linear solver lanes x acceptance modes; `banded_pallas`
through BandedKernel, K5/K7) plus `schur_pallas` (the dense kernels
K1-K3), over its five problems of the zoo in float64, then one float32
row under matmul_precision="high" (one-pass TF32 in K1-K3 and cuBLAS, the
knob's meaning on a GPU).  A cell records the status (OK where it is the
expected one), the outer iterations and the seconds; one that raises is
`ERR(<exception>)`, and the script exits 1 if any cell raised.

    python3 tools/config_matrix.py                 # the card
    python3 tools/config_matrix.py --device cpu    # a rehearsal

Prints the grid as a markdown table and the figures as one JSON line;
`--out PATH.json` also writes them (PATH.json and PATH.md).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# scripts/run_config_matrix_tpu.py's configs, and schur_pallas
CONFIGS = {
    "schur_xla": {},
    "schur_invchol": {"kkt.linear_solver_type": "invchol"},
    "schur_pallas": {"kkt.linear_solver_type": "pallas"},
    "banded_pallas": {"kkt.linear_solver_type": "pallas"},
    "schur_f32fb": {"kkt.factor_precision": "f32_fallback"},
    "symmetric_ldlt": {"kkt.kkt_solver_type": "symmetric"},
    "clever_ldlt": {"kkt.kkt_solver_type": "clever_symmetric"},
    "clever_eigh": {"kkt.kkt_solver_type": "clever_symmetric",
                    "kkt.linear_solver_type": "eigh"},
    "filter_test2": {"ls.filter_type": "test2"},
    "agg_constant": {"ls.agg_gamma": "constant"},
}
# (row, config, dtype, extra options): every config in float64, then the
# dense kernels in float32 under "high"
ROWS = [(name, name, "float64", {}) for name in CONFIGS]
ROWS.append(("schur_pallas_f32_high", "schur_pallas", "float32",
             {"matmul_precision": "high"}))
# the problems results/config_matrix_tpu.md ran, with their statuses
PROBLEMS = {
    "toy_lp1": "Optimal",
    "rosenbrook2": "Optimal",
    "circle_nc1": "Optimal",
    "toy_lp_inf1": "primal_infeasible",
    "lp_unbd": "dual_infeasible",
}


def run_cell(config, dtype, extra, problem, device, max_it):
    """One solve: (status, iterations)."""
    import torch
    import onephase_tpu_torch as opt
    from onephase_tpu_torch.config import Params
    from onephase_tpu_torch.models import zoo
    from onephase_tpu_torch.parallel.banded import BandedKernel

    pars = Params().with_overrides({
        "output_level": 0, "term.max_it": max_it, "a_norm_penalty": 1e-4,
        **CONFIGS[config], **extra})
    nlp = opt.canonicalize(getattr(zoo, problem)(),
                           dtype=getattr(torch, dtype), device=device)
    kernel = (BandedKernel(nlp, pars, device=device)
              if config == "banded_pallas" else None)
    r = opt.one_phase_solve(nlp, pars, kernel=kernel)
    return r.status, r.iterations


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-it", type=int, default=81)
    ap.add_argument("--out", default=None,
                    help="also write the figures here (.json) and the grid "
                         "beside them (.md)")
    args = ap.parse_args()
    import torch
    sys.path.insert(0, str(ROOT))
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("config_matrix: no CUDA device (--device cpu "
                             "rehearses on the CPU)")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    else:
        card = "cpu (rehearsal)"
    print(f"card: {card}", flush=True)
    table, errors = {}, []
    t_all = time.perf_counter()
    for row, config, dtype, extra in ROWS:
        for problem, want in PROBLEMS.items():
            t0 = time.perf_counter()
            try:
                status, its = run_cell(config, dtype, extra, problem,
                                       args.device, args.max_it)
                rec = {"status": status, "ok": status == want, "it": its}
            except Exception as e:  # noqa: BLE001 -- a cell that raises
                rec = {"status": f"ERR({type(e).__name__}: {e})",
                       "ok": False}
                errors.append(f"{row}/{problem}")
            rec.update(want=want, s=round(time.perf_counter() - t0, 3))
            table.setdefault(row, {})[problem] = rec
            print(f"{row:>22} {problem:<12} {rec['status']:<18} "
                  f"{'ok' if rec['ok'] else 'MISMATCH'} "
                  f"({rec.get('it', '-')} its, {rec['s']} s)", flush=True)
    payload = {"card": card, "device": args.device,
               "seconds": round(time.perf_counter() - t_all, 1),
               "cells": sum(len(v) for v in table.values()),
               "mismatches": [f"{r}/{p}" for r, v in table.items()
                              for p, c in v.items() if not c["ok"]],
               "errors": errors, "table": table}
    lines = [f"# Config matrix of the port on {card}", "",
             "| config | " + " | ".join(PROBLEMS) + " |",
             "|---" * (len(PROBLEMS) + 1) + "|"]
    for row, cells in table.items():
        lines.append(f"| {row} | " + " | ".join(
            ("OK" if c["ok"] else c["status"].split(":")[0])
            + f" ({c.get('it', '-')})" for c in cells.values()) + " |")
    lines.append(f"\n{payload['cells']} cells, {len(payload['mismatches'])}"
                 f" not the expected status, {len(errors)} raised; "
                 f"{payload['seconds']} s")
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(payload, indent=1))
        out.with_suffix(".md").write_text("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)
    print(json.dumps({k: v for k, v in payload.items() if k != "table"}),
          flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
