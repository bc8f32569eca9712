#!/usr/bin/env python
"""The JAX package's reference figures for chip_smoke.py's mixed-precision
phase, on the CPU.

Solves bench.make_qp(MIXED_SHAPE) in float64 from chip_smoke.py's starts
(default_rng(1) normal * 0.1) with the JAX package's BatchSolver on the
pallas lane (its Pallas kernels in interpret mode, so under vmap its
Q formation, Cholesky and inverse run as XLA ops) and MIXED_OPTIONS, once
for each run of MIXED_RUNS (factor_precision "same", "f32" and the
fast-f64 lane), and prints one JSON line per run: the statuses, the
indices of the certified instances, outer iterations and factorizations
per instance and in sum, and CPU seconds.  The seconds are CPU seconds of
the JAX package, not a figure of any accelerator.  It takes a few minutes
and a few GB of host memory at the full shape.

    python tools/jax_dense_anchor.py [--runs same,f32,f32_fallback]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default="same,f32,f32_fallback")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    import onephase_tpu.ops as jops
    from bench import make_qp
    from chip_smoke import MIXED_OPTIONS, MIXED_RUNS, MIXED_SHAPE
    from onephase_tpu.config import Params
    from onephase_tpu.ipm.state import OPTIMAL
    from onephase_tpu.nlp import canonicalize
    from onephase_tpu.parallel.batch import BatchSolver

    n, m, B = MIXED_SHAPE["n"], MIXED_SHAPE["m"], MIXED_SHAPE["batch"]
    nlp = canonicalize(make_qp(n, m, seed=0), dtype=jnp.float64)
    x0s = np.random.default_rng(1).normal(size=(B, nlp.n)) * 0.1
    for run in args.runs.split(","):
        pars = Params().with_overrides(dict(
            MIXED_OPTIONS, **MIXED_RUNS[run],
            **{"kkt.linear_solver_type": "pallas"}))
        jops.INTERPRET = True
        try:
            t0 = time.time()
            solver = BatchSolver(nlp, pars)
            st = solver.solve(x0s)
            jax.block_until_ready(st.p.x)
            seconds = time.time() - t0
        finally:
            jops.INTERPRET = False
        status = np.asarray(st.status)
        t = np.asarray(st.t) - 1
        fac = np.asarray(st.cum_fac)
        print(json.dumps({
            "run": run, "problem": f"make_qp(n={n}, m={m})", "batch": B,
            "dtype": "float64", "platform": "cpu",
            "certified": np.flatnonzero(status == OPTIMAL).tolist(),
            "statuses": solver.statuses(st), "outer_its": t.tolist(),
            "outer_its_sum": int(t.sum()), "cum_fac": fac.tolist(),
            "cum_fac_sum": int(fac.sum()),
            "cpu_seconds_with_compile": seconds}), flush=True)


if __name__ == "__main__":
    main()
