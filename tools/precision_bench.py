#!/usr/bin/env python3
"""The bench QP 256/128/16 in float32 under every `matmul_precision` name
of the TPU's records, on the card: the full set of `chip_smoke.py`'s
precision phase (PREC_BENCH_ALL), whose non-certifying runs go to MAX_IT
(960 outer iterations) and do not fit the script's time limit.

    python3 tools/precision_bench.py                      # every run
    python3 tools/precision_bench.py --runs pallas:high invchol:high
    python3 tools/precision_bench.py --seeds 0 1 2 3 \
        --runs pallas:highest invchol:highest \
        pallas:BF16_BF16_F32_X6 invchol:BF16_BF16_F32_X6

Each run prints its line (certified, outer its, factorizations, seconds,
K1/K2/K3 launches by mode) beside the TPU's records (PREC_TPU_INVCHOL);
`pallas` runs must launch K1-K3 in the run's mode.  `--seeds` repeats the
runs on other draws of the QP and its starts (seed s: make_qp(seed=s),
starts from seed s + 1; 0 is the bench's and the TPU's records'): the
spread of the certified counts across draws.  The last line is one JSON
object of the figures.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", nargs="+", default=None,
                    help="lane:name pairs (default: PREC_BENCH_ALL)")
    ap.add_argument("--seeds", nargs="+", type=int, default=[0],
                    help="draws of the QP and its starts (default: 0)")
    args = ap.parse_args()
    runs = (cs.PREC_BENCH_ALL if args.runs is None else
            [tuple(r.split(":", 1)) for r in args.runs])
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("precision_bench: no CUDA device; it runs on the "
                         "GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    rows = []
    for seed in args.seeds:
        out = cs.precision_bench(torch.device("cuda"), runs, seed=seed)
        rows += [{"seed": seed, "lane": lane, "name": name,
                  "certified": r["solved"], "outer_its": r["outer_its"],
                  "factorizations": r["cum_fac"], "seconds": r["seconds"],
                  "launch_modes": r["launch_modes"]}
                 for (lane, name), r in out.items()]
    print(json.dumps({"card": card, "runs": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
