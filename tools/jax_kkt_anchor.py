#!/usr/bin/env python
"""The JAX package's reference figures for chip_smoke.py's KKT-system
phase, on the CPU in float64.

- The LP pool: chip_smoke.kkt_lp(seed) for each seed of KKT_LP_SHAPE, one
  BatchSolver (B = 1) an LP from x = 0, on each path of KKT_LP_PATHS (the
  pallas lane with its Pallas kernels in interpret mode, so under vmap its
  Q formation, Cholesky and inverse run as XLA ops).
- The bench QP (bench.make_qp at KKT_QP_SHAPE) on each run of
  KKT_QP_RUNS from chip_smoke.py's starts (default_rng(1) normal * 0.1).

All with KKT_OPTIONS.  It prints one JSON line per run: the statuses,
outer iterations and factorizations per instance and in sum, mr for the
QP runs, the objectives for the LP paths, and CPU seconds (of the JAX
package, not a figure of any accelerator), then one line with the LP
pool's objective gap between its paths.  The whole takes about an hour
and a few GB of host memory; `--runs` and `--seeds` take a part (a
prefix of a masked batch runs as in the whole: instances are independent).

    python tools/jax_kkt_anchor.py [--runs schur_dual,schur_pallas,symmetric,...]
                                   [--seeds N] [--batch B]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _summary(run, solver, st, seconds, **extra):
    import numpy as np
    t = np.asarray(st.t) - 1
    fac = np.asarray(st.cum_fac)
    return dict({"run": run, "statuses": solver.statuses(st),
                 "outer_its": t.tolist(), "outer_its_sum": int(t.sum()),
                 "cum_fac": fac.tolist(), "cum_fac_sum": int(fac.sum()),
                 "dtype": "float64", "platform": "cpu",
                 "cpu_seconds_with_compile": seconds}, **extra)


def main():
    import chip_smoke as cs
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default=",".join(
        list(cs.KKT_LP_PATHS) + list(cs.KKT_QP_RUNS)))
    ap.add_argument("--seeds", type=int, default=cs.KKT_LP_SHAPE["seeds"])
    ap.add_argument("--batch", type=int, default=0,
                    help="a prefix of each QP run's batch (0: all of it)")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    import onephase_tpu.ops as jops
    from bench import make_qp
    from onephase_tpu.config import Params
    from onephase_tpu.models.lp import LPData
    from onephase_tpu.nlp import canonicalize
    from onephase_tpu.parallel.batch import BatchSolver

    objs = {}
    for run in args.runs.split(","):
        if run in cs.KKT_LP_PATHS:
            n, m = cs.KKT_LP_SHAPE["n"], cs.KKT_LP_SHAPE["m"]
            pars = Params().with_overrides(dict(cs.KKT_OPTIONS,
                                                **cs.KKT_LP_PATHS[run]))
            statuses, its, facs, obj, secs = [], [], [], [], 0.0
            for seed in range(args.seeds):
                nlp = canonicalize(LPData(*cs.kkt_lp(seed, n, m)).to_spec(),
                                   dtype=jnp.float64)
                jops.INTERPRET = True
                try:
                    t0 = time.time()
                    solver = BatchSolver(nlp, pars)
                    st = solver.solve(np.zeros((1, n)))
                    jax.block_until_ready(st.p.x)
                    secs += time.time() - t0
                finally:
                    jops.INTERPRET = False
                statuses += solver.statuses(st)
                its.append(int(st.t[0]) - 1)
                facs.append(int(st.cum_fac[0]))
                obj.append(float(nlp.f(st.p.x[0])))
                print(json.dumps({"run": run, "seed": seed,
                                  "status": statuses[-1], "outer_its": its[-1],
                                  "cum_fac": facs[-1], "obj": obj[-1]}),
                      flush=True)
            objs[run] = obj
            print(json.dumps({
                "run": run, "problem": f"kkt_lp(seed, n={n}, m={m})",
                "seeds": args.seeds, "statuses": statuses, "outer_its": its,
                "outer_its_sum": sum(its), "cum_fac": facs,
                "cum_fac_sum": sum(facs), "obj": obj, "dtype": "float64",
                "platform": "cpu", "cpu_seconds_with_compile": secs}),
                flush=True)
            continue
        extra, batch = cs.KKT_QP_RUNS[run]
        batch = args.batch or batch
        n, m = cs.KKT_QP_SHAPE["n"], cs.KKT_QP_SHAPE["m"]
        pars = Params().with_overrides(dict(cs.KKT_OPTIONS, **extra))
        nlp = canonicalize(make_qp(n, m, seed=0), dtype=jnp.float64)
        x0s = np.random.default_rng(1).normal(size=(batch, nlp.n)) * 0.1
        t0 = time.time()
        solver = BatchSolver(nlp, pars)
        st = solver.solve(x0s)
        jax.block_until_ready(st.p.x)
        print(json.dumps(_summary(
            run, solver, st, time.time() - t0,
            problem=f"make_qp(n={n}, m={m})", batch=batch,
            mr=int(solver.kernel.mr))), flush=True)
    if len(objs) == 2:
        gaps = [abs(a - b) / abs(b) for a, b in zip(*objs.values())]
        print(json.dumps({"lp_obj_gap": gaps, "lp_obj_gap_max": max(gaps),
                          "lp_obj_gap_within_1e-7":
                          sum(g <= 1e-7 for g in gaps)}), flush=True)


if __name__ == "__main__":
    main()
