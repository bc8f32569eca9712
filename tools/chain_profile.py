#!/usr/bin/env python3
"""Device profile of the port's chain or banded path on a CUDA card.

Runs chip_smoke.py's chain configuration (CHAIN_SHAPE, CHAIN_OPTIONS:
scripts/bench_large.py's) in float32 through ChainKernel or, with
`--kernel banded`, as a flat NLP through the matrix-free BandedKernel with
its pattern passed in (chip_smoke.py's banded run), as chip_smoke.py
does: a warm-up chunk, an unprofiled timed run from a fresh state, then the
same run under torch.profiler (CPU + CUDA activities).  It prints one JSON
line: wall seconds of both runs, device busy milliseconds (the sum of the
device-side events of the profiled run: kernels and copies), the idle
share, the launches of K5/K7 and the top device consumers by name.  The
idle share is 1 - busy / the UNPROFILED run's wall time: the profiler
stretches the host side of the run it traces, not the device work.  The
card's name and power limit are printed first.  It needs a card; it does
not fall back to the CPU.

    python3 tools/chain_profile.py [--kernel chain|banded] [--lane pallas|xla]
"""
import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TOP = 12


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lane", default="pallas", choices=("pallas", "xla"))
    ap.add_argument("--kernel", default="chain", choices=("chain", "banded"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chain_profile: no CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (CHAIN_OPTIONS, CHAIN_SHAPE, banded_kernel,
                            chain_pattern)
    from onephase_tpu_torch import ops
    from onephase_tpu_torch.config import Params
    from onephase_tpu_torch.ipm.state import RUNNING, STATUS_NAMES
    from onephase_tpu_torch.models.examples import chain_ocp
    from onephase_tpu_torch.parallel.chain import ChainKernel

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    pars = Params().with_overrides(
        dict(CHAIN_OPTIONS, **{"kkt.linear_solver_type": args.lane}))
    if args.kernel == "banded":
        ck = banded_kernel(dev, CHAIN_SHAPE, args.lane, True, chain_pattern(
            CHAIN_SHAPE["K"], CHAIN_SHAPE["nx"]))
    else:
        ck = ChainKernel(chain_ocp(**CHAIN_SHAPE, device=dev), pars,
                         dtype=torch.float32, device=dev)

    def run():
        st = ck.initial_state()
        while int(st.status[0]) == RUNNING:
            st = ck.run_chunk(st)
        torch.cuda.synchronize()
        return st

    ck.run_chunk(ck.initial_state())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0

    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = run()
        wall_prof = time.perf_counter() - t0
    launches = ops.launch_counts()

    by_name = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]

    def share(pattern):
        hits = [(n, c, ms) for n, (c, ms) in by_name.items() if pattern in n]
        return {"events": sum(c for _, c, _ in hits),
                "device_ms": sum(ms for _, _, ms in hits)}

    out = {
        "problem": "chain_ocp({})".format(
            ", ".join(f"{k}={v}" for k, v in CHAIN_SHAPE.items())),
        "kernel": args.kernel, "lane": args.lane, "dtype": "float32",
        "status": STATUS_NAMES[int(st.status[0])],
        "outer_its": int(st.t[0]) - 1, "cum_fac": int(st.cum_fac[0]),
        "wall_s_unprofiled": wall, "wall_s_profiled": wall_prof,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (wall * 1e3),
        "device_events": sum(c for c, _ in by_name.values()),
        "launches": launches,
        "tridiag_factor_kernel": share("tridiag_factor_kernel"),
        "tridiag_solve_kernel": share("tridiag_solve_kernel"),
        "top": [{"name": n[:100], "events": c, "device_ms": ms,
                 "share_of_busy": ms / busy_ms} for n, (c, ms) in top],
        "device": torch.cuda.get_device_name(0), "card": card,
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
