#!/usr/bin/env python
"""The JAX package's reference figures for chip_smoke.py's scenario phase,
on the CPU.

Runs each configuration of the phase (chip_smoke.py's SCEN_* constants)
with the JAX package: S1 two_stage_qp(K=256, nz=16, nx=64, mc=32) in
float32 at tol 1e-4 on its ScenarioKernel (its xla lane: the block factor is
`jnp.linalg.cholesky` on every lane); S2 two_stage_qp(K=64, nz=16, nx=64,
mc=32) and S3 tax_grouped(G=64, na_g=8, wage_spread="banded") in float64,
each on the ScenarioKernel and on the dense OnePhaseKernel of the flat NLP;
S4 ECON50 and the six examples on the dense path in float64.  Each run goes
from its initial state to termination, chunk by chunk, as chip_smoke.py
runs it, and adds one JSON line (status, outer iterations, factorizations,
CPU seconds) to the output; the last line is the `SCEN_JAX_ANCHOR` dict
that chip_smoke.py holds.  The seconds are the JAX package's on a CPU,
not a figure of any accelerator.  It writes no file.

    python tools/jax_scenario_anchor.py [--runs S1,S2,S3,S4]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default="S1,S2,S3,S4")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from chip_smoke import (SCEN_OPTIONS, SCEN_S1, SCEN_S1_OPTIONS, SCEN_S2,
                            SCEN_S3, SCEN_S3_OPTIONS, SCEN_S4,
                            SCEN_S4_OPTIONS)
    from onephase_tpu.config import Params
    from onephase_tpu.ipm.core import OnePhaseKernel
    from onephase_tpu.ipm.state import STATUS_NAMES
    from onephase_tpu.models import examples, tax
    from onephase_tpu.nlp import canonicalize
    from onephase_tpu.parallel.scenario import ScenarioKernel

    def pars(base):
        return Params().with_overrides(
            dict(base, **{"kkt.linear_solver_type": "xla"}))

    anchor = {}

    def run(key, kernel):
        t0 = time.time()
        st = kernel.initial_state()
        while int(st.status) == 0:            # RUNNING
            st = kernel.run_chunk(st)
        jax.block_until_ready(st.p.x)
        anchor[key] = {"status": STATUS_NAMES[int(st.status)],
                       "outer_its": int(st.t) - 1,
                       "cum_fac": int(st.cum_fac)}
        print(json.dumps(dict(anchor[key], run=key,
                              cpu_seconds=time.time() - t0)), flush=True)

    runs = args.runs.split(",")
    if "S1" in runs:
        run("S1", ScenarioKernel(examples.two_stage_qp(**SCEN_S1),
                                 pars(SCEN_S1_OPTIONS), dtype=jnp.float32))
    twins = (("S2", examples.two_stage_qp(**SCEN_S2), SCEN_OPTIONS),
             ("S3", tax.tax_grouped(**SCEN_S3), SCEN_S3_OPTIONS))
    for key, spec, base in twins:
        if key not in runs:
            continue
        run(key + "_arrow", ScenarioKernel(spec, pars(base)))
        run(key + "_dense", OnePhaseKernel(canonicalize(spec.to_nlpspec()),
                                           pars(base)))
    if "S4" in runs:
        mods = {"examples": examples, "tax": tax}
        for name, (mod, fn, fargs) in SCEN_S4.items():
            spec = getattr(mods[mod], fn)(*fargs)
            run(name, OnePhaseKernel(canonicalize(spec),
                                     pars(SCEN_S4_OPTIONS)))
    print(json.dumps(anchor), flush=True)


if __name__ == "__main__":
    main()
