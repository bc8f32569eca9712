#!/usr/bin/env python
"""The JAX package's reference figures for chip_smoke.py's campaign phase,
on the CPU.

For each pool of the phase (chip_smoke.py's CAMP_* constants: C1
sized_mixed_suite(1024, 512, n_pairs=32, density=0.5), C2
mixed_suite(n_pairs=48, max_n=600)) it runs:

- the JAX package's `solve_bucketed` in float64 with the phase's options
  and `term.max_it` capped at 80, the options of the float64 escalation
  pass: each instance's status, objective and outer iterations.  Its
  `pallas` lane runs in interpret mode, as the JAX package's own tests run
  it on the CPU (under vmap its Pallas kernels fall back to XLA there,
  ROADMAP R2; outside interpret mode the batched triangular inverse of
  that fallback fails to lower on the CPU);
- `baselines.scipy_linprog_solve` (HiGHS) on each feasible member: its
  objective.

The last line is the `CAMP_JAX_ANCHOR` dict that chip_smoke.py holds
({pool: {instance: [status, objective, outer its, HiGHS objective or
None]}}); the lines before it are one JSON line per pool with its CPU
seconds (the JAX package's on a CPU, not a figure of any accelerator).  It
writes no file.  The float64 solves run in batches of `--max-batch`
instances (16: about 1 GB at n = 1024); an instance's result does not
depend on its batch.

    python tools/jax_campaign_anchor.py [--pools C1,C2] [--max-batch 16]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ESC_MAX_IT = 80      # onephase_tpu/parallel/buckets.py:272-273


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pools", default="C1,C2")
    ap.add_argument("--max-batch", type=int, default=16)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import onephase_tpu.ops as jops
    from chip_smoke import (CAMP_C1, CAMP_C2, CAMP_C2_OPTIONS, CAMP_OPTIONS,
                            CAMP_ROUND_TO)
    from onephase_tpu.baselines import scipy_linprog_solve
    from onephase_tpu.config import Params
    from onephase_tpu.models.netlib import mixed_suite, sized_mixed_suite
    from onephase_tpu.parallel.buckets import solve_bucketed

    pools = {
        "C1": (lambda: sized_mixed_suite(CAMP_C1["n"], CAMP_C1["m"],
                                         n_pairs=CAMP_C1["n_pairs"],
                                         density=CAMP_C1["density"]),
               CAMP_OPTIONS),
        "C2": (lambda: mixed_suite(**CAMP_C2), CAMP_C2_OPTIONS),
    }
    jops.INTERPRET = True
    anchor = {}
    for key in args.pools.split(","):
        make, base = pools[key]
        problems = make()
        pars = Params().with_overrides(base)
        pars = pars.with_overrides(
            {"term.max_it": min(pars.term.max_it, ESC_MAX_IT)})
        t0 = time.time()
        res = solve_bucketed(problems, pars, round_to=CAMP_ROUND_TO,
                             max_batch=args.max_batch, dtype=jnp.float64)
        t_jax = time.time() - t0
        t0 = time.time()
        highs = {name: scipy_linprog_solve(d, pars)
                 for name, d in problems.items() if name.endswith("_feas")}
        t_highs = time.time() - t0
        anchor[key] = {
            name: [res[name].status, res[name].obj, res[name].iterations,
                   highs[name].obj if name in highs else None]
            for name in sorted(problems)}
        counts = {}
        for v in anchor[key].values():
            counts[v[0]] = counts.get(v[0], 0) + 1
        print(json.dumps({"pool": key, "instances": len(problems),
                          "statuses": counts,
                          "jax_cpu_seconds": t_jax,
                          "highs_seconds": t_highs}), flush=True)
    print(json.dumps(anchor), flush=True)


if __name__ == "__main__":
    main()
