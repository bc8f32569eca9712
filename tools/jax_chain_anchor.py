#!/usr/bin/env python
"""The JAX package's reference figure for the port's chain and banded paths,
on the CPU.

Solves chip_smoke.py's chain configuration (CHAIN_SHAPE: chain_ocp(K=400,
nx=32, mc=16); CHAIN_OPTIONS: the options of scripts/bench_large.py:46-66,
tol 1e-4, max_it 200, chunk_size 25, history_capacity 2) with the JAX
package's ChainKernel in float32, x64 off as that script runs it, and
prints one JSON line: status, outer iterations, factorizations and seconds
for each lane.  With `--kernel banded` the same problem goes as a flat NLP
through the JAX package's BandedKernel(matrix_free=True, pattern=...) with
chip_smoke.py's block-tridiagonal pattern (`--K` cuts the number of stages
where the full size takes too long on a CPU).  It writes no file
(scripts/bench_large.py itself rewrites results/).  The seconds are CPU seconds of the JAX package, not a
figure of any accelerator.

    python tools/jax_chain_anchor.py [--kernel chain|banded]
                                     [--lanes xla,pallas] [--K stages]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", default="xla,pallas")
    ap.add_argument("--kernel", default="chain", choices=("chain", "banded"))
    ap.add_argument("--K", type=int, default=None,
                    help="stages, where fewer than CHAIN_SHAPE's")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    import onephase_tpu.ops as jops
    from chip_smoke import CHAIN_OPTIONS, CHAIN_SHAPE, chain_pattern
    from onephase_tpu.config import Params
    from onephase_tpu.ipm.state import STATUS_NAMES
    from onephase_tpu.models.examples import chain_ocp
    from onephase_tpu.nlp import canonicalize
    from onephase_tpu.parallel.banded import BandedKernel
    from onephase_tpu.parallel.chain import ChainKernel

    shape = dict(CHAIN_SHAPE, **({"K": args.K} if args.K else {}))
    spec = chain_ocp(**shape)
    out = {"problem": "chain_ocp({})".format(
               ", ".join(f"{k}={v}" for k, v in shape.items())),
           "kernel": args.kernel, "dtype": "float32", "platform": "cpu"}

    def make(pars):
        if args.kernel == "chain":
            return ChainKernel(spec, pars, dtype=jnp.float32)
        t0 = time.time()
        bk = BandedKernel(
            canonicalize(spec.to_nlpspec(), dtype=jnp.float32), pars,
            matrix_free=True,
            pattern=chain_pattern(shape["K"], shape["nx"]))
        out["banded"] = {"bandwidth": bk.bandwidth, "nb": bk.nb, "K": bk.K,
                         "n_pad": bk.n_pad,
                         "constructor_s": time.time() - t0}
        return bk

    for lane in args.lanes.split(","):
        pars = Params().with_overrides(
            dict(CHAIN_OPTIONS, **{"kkt.linear_solver_type": lane}))
        # the pallas lane's solve kernel runs in interpret mode off the TPU
        jops.INTERPRET = lane == "pallas"
        try:
            t0 = time.time()
            ck = make(pars)
            st = ck.run_chunk(ck.initial_state())
            jax.block_until_ready(st.p.x)
            compile_s = time.time() - t0
            t0 = time.time()
            st = ck.initial_state()
            while int(np.asarray(st.status)) == 0:
                st = ck.run_chunk(st)
            jax.block_until_ready(st.p.x)
            solve_s = time.time() - t0
        finally:
            jops.INTERPRET = False
        out[lane] = {"status": STATUS_NAMES[int(st.status)],
                     "iterations": int(st.t) - 1,
                     "cum_fac": int(st.cum_fac),
                     "obj": float(st.cache.fval),
                     "cpu_solve_s": solve_s, "cpu_compile_s": compile_s}
        print(json.dumps({lane: out[lane]}), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
