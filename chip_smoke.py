#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`onephase_tpu_torch`).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from `onephase_tpu_torch/csrc/`, holds
each against its plain PyTorch version on the card, then drives the port's
paths on the `pallas` lane:

- the dense path (`NLPSpec -> canonicalize -> OnePhaseKernel (dense Schur)
  -> one_phase_solve / BatchSolver`): HS071 in float64, the bench
  configuration (n=256, m=128, batch 16, float32) and the n=1024, m=512,
  batch 64 configuration with adaptive refinement (kernels K1-K3);
- the precision knobs on the dense path: the QP at n=1024, m=512, batch
  16 in float64 at tol 1e-6 with adaptive refinement (MIXED_RUNS), with
  the factor in float64, in float32 (K1-K3 launched on float32 operands
  under the float64 solve) and on the fast-f64 lane; then 256/128/16
  float32 on `invchol` under residual_precision="f64" (every certificate
  must pass the float64 termination test) and on `pallas` under
  q_form_dtype="bf16" (no Q kernel launch: the reference's dispatch);
- `Params.matmul_precision` on the card (the precision phase, after the
  mixed phase; ops/precision.py): the resolver's table on `cuda`; K1 (and
  its lower mode, K3's Gram half), K2 and K3 in every mode the card
  takes (TF32, TF32_X3, BF16 1/3/6/9 products, F16): on inputs with one
  product an entry each kernel bit for bit its twin in every mode and off
  the IEEE kernel where the mode takes at most 3 products; at 1024/512/64
  against their twins (PREC_TOL) and against the recurrence each
  computes, in float64 on its own output (TF32, BF16 and F16 at least
  10x closer to their mode's than to IEEE's), timed in turns with the
  IEEE kernel beside the bound (operations x products over the tensor
  cores' rate for the mode's input type, and over the FP32 rate), K1
  under TF32 beside `baddbmm` with cuBLAS's TF32; the mixed phase's
  float64 "same" run under "high", x bit for bit "highest"'s; the bench
  QP 256/128/16 float32 under BF16_BF16_F32_X6 on `pallas` (K1-K3
  launched in the run's mode), beside the TPU's records of that
  configuration (PREC_TPU_INVCHOL; tools/precision_bench.py runs the
  other names and the `invchol` lane); K7 and K5 in every mode at the
  chain's (K=400, nb=32) and the banded path's (K=204, nb=63) shapes,
  timed in turns with their IEEE kernels beside their bounds;
- K7 and K5 in every mode against their twins (a later phase,
  `tridiag_mode_phase`): the band within `_tridiag_tol`, K7's output
  within TRIDIAG_RESIDUAL_TOL of its mode's recurrences (TF32, BF16 and
  F16 at least 10x closer than the IEEE kernel's), one-product operands
  (`tridiag_one_product_operands`) bit for bit and off the IEEE kernels
  where the mode takes at most 3 products; then the chain path on
  `pallas` under "high" and BF16_BF16_F32_X6 (CHAIN_MODE_RUNS), K5 and K7
  launched in the run's mode, printed beside the IEEE run;
- the chain path (`chain_ocp -> ChainKernel (block-tridiagonal Schur) ->
  run_chunk`): chain_ocp(K=400, nx=32, mc=16) in float32, the JAX
  package's large-instance configuration (scripts/bench_large.py), on the
  `pallas` lane (kernels K5 and K7) and on the `xla` lane for comparison;
- the RCM-banded path (`NLPSpec -> canonicalize -> BandedKernel ->
  run_chunk`): the same chain_ocp(K=400, nx=32, mc=16) as a flat NLP in
  float32, matrix-free, with its block-tridiagonal pattern passed in
  (bandwidth 63 after RCM: K5 and K7 at nb=63), held to the chain path's
  argmin; then K=50 assembled against matrix-free and `pallas` against
  `xla`;
- every other KKT system of the dense driver (the kkt phase), float64
  through BatchSolver at tol 1e-6: a pool of 16 LPs (n=1024, m=512,
  tests/test_dual.py's recipe) on `schur_dual` and on `schur`/`pallas`
  (K1-K3), which must agree in statuses and objectives; the bench QP at
  n=256, m=128 on `symmetric` and `clever_symmetric` (batch 8; also with
  kkt_system_rescale="u_and_x") and `symmetric` with the eigh backend
  (batch 4).  Every count is held to the JAX package's on the CPU
  (KKT_JAX_ANCHOR, tools/jax_kkt_anchor.py); the plain LDL^T's and eigh's
  ms and CUDA launches a factorization, and the dual path's S factor
  against K2, are printed;
- the scenario path (`TwoStageSpec -> ScenarioKernel (arrow Schur) ->
  run_chunk`, the scenario phase): two_stage_qp(K=256, nz=16, nx=64,
  mc=32) in float32 (flat n = 16,400) on the `pallas` lane (K2 on the
  (256, 64, 64) scenario blocks and the 16 x 16 border) and the `xla`
  lane; two_stage_qp(K=64) and tax_grouped(G=64, na_g=8, "banded") in
  float64, each against the dense path of its flat NLP; ECON50 and six
  example problems on the dense path.  Every status is held to the JAX
  package's on the CPU (SCEN_JAX_ANCHOR, tools/jax_scenario_anchor.py),
  and K2 is held to its plain version and timed at the path's shapes, down
  to n = 1.

- the LP campaign path (`cli.main` / `harness.run_lp_directory` ->
  `parallel/buckets.solve_bucketed`, the campaign phase): shape-bucketed
  parametric LP batches in float32 on the `pallas` lane, each instance its
  own A (K1 on a (B, m, n) Jc, K2, K3), with one float64 escalation pass
  on the card.  C1: 32 LPs at n=1024, m=512 (one shape class) on `pallas`
  and on `invchol` (no kernel); C2: 48 instances of the mixed pool (six
  shape classes); C3: seven MPS files through run_lp_directory, then the
  CLI twice into one directory (the second call skips every problem).
  Every final status must be its ground truth (the `_feas` / `_infeas`
  suffix) or, for an escalated instance, the JAX package's float64 status
  (CAMP_JAX_ANCHOR, tools/jax_campaign_anchor.py); every Optimal
  objective within CAMP_OBJ_RTOL of HiGHS's.  K1 with a per-instance Jc
  is held to its plain version and timed at C1's shape.
- the multi-device layer (`parallel/mesh.py`, `dryrun.py`, the mesh
  phase, MESH_*): two ranks share the card over `gloo` (NCCL refuses two
  ranks on one device; gloo runs all_reduce, the port's one collective,
  on CUDA tensors), then one rank runs over `nccl`.  The dry run
  (`dryrun.rank_dryrun`: a dp batch of tax1d, the scenario-sharded
  tax_grouped(G=16), the sharded arrow primitive on K2, the
  partition-sharded chain; each to termination); M1 the mixed phase's
  float64 QP and the bench configuration through ShardedBatchSolver, 8
  instances a rank (K1-K3 on every rank); M2 S1 with 128 scenarios a rank
  (K2 on every rank); M3 the arrow primitive against the local solve; M4
  the K=400 chain with 8 partitions and the K=50 banded run with 2 over
  the ranks; M5 M1's float64 leg over nccl.  Each is held to the same
  run unsharded (and a rank's rows to the same rows solved at its batch).
  The dry run and M1-M4 share one gloo world.  The ranks start with the
  `spawn` method and meet at a `file://` store; a rank that fails or
  hangs past MESH_TIMEOUT fails the phase.

The phases up to the precision phase, and K2's times at the scenario
shapes, run alone on the card: every time in the kernels line is theirs.
The later phases then share the card (`later_phases`): the scenario
phase followed by K7/K5's twin checks and the chain runs under the
modes, and the campaign phase, each run in a spawned process of its own,
and the mesh phase's ranks start with them, while this process runs the
chain, banded and kkt phases and the mesh phase's unsharded runs, so the
seconds those phases print are taken beside one another.  A child that fails or outlives
PHASE_TIMEOUT fails the script, and every child is killed when it ends.

The mixed phase also times K1, K2 and K3 at its shape in float64 and in
float32, in turns.

K6 (the triangle-tiled fused Q) lies on no path of either package; its
wrapper launches K1's kernel (`csrc/fused_q.cu`), whose `lower` mode is
also K3's Gram half.  It is held in the kernel phase against its plain
version and against K1 (whose full Q it must equal bit for bit).

The kernel phase also times, in turns at both dense shapes (n=256/B=16
and n=1024/B=64), K1 against its plain version and `torch.baddbmm` (also
at n=2048/m=1024/B=16), K2 against its plain version and
`torch.linalg.cholesky_ex`, and K3 against its plain version and
`torch.cholesky_inverse` (the library yardsticks, never called by the
port) with its two launches (triangular inverse, Gram product) timed
apart, each with its achieved TFLOP/s beside its bound; K6 in turns with
K1, its plain version and `torch.baddbmm`; and K7 against its plain
version in turns with its time per stage at both band shapes, and K5 with
its device time (`torch.profiler`) beside its byte bound and its
dependence bound (2K stages of two chains of nb FMAs).  The build's
`-Xptxas -v` lines (registers, spills) of the K1 (K6, K3's Gram), K2, K3,
K5 and K7 kernels are printed first, and a spill anywhere in the build
fails the script; after the kernel phase torch.profiler's kernel names
show the float64 launches of K1, K6 and K3's Gram half on the FP64
tensor cores (`fused_q_dmma_kernel`) and K3's moded inverse on its own
instantiation (`tri_inv_mode_kernel`).  Float32 products run without TF32
outside the precision phase.

Every phase raises on failure, so the script exits nonzero and never prints
the final line; without a CUDA card it refuses to run.  The line before
the last lists every kernel with its launches on its path, its error
against the plain version, its time, the plain version's, a library
call's where one PyTorch call computes the same function, and its bound
(K1-K3 also with their records in each matmul mode at n=1024, and K5
and K7 at their two shapes, with their launches on the chain runs under
the modes, `modes`; K1-K3 also with their launches on the mixed phase's
float32 run, on
the kkt phase's LP pool and on the campaign's C1 run, K1 also with its
per-instance-Jc record; K2 also with its launches on the scenario run and
its times at the scenario shapes; K1-K3 also with their launches on each
rank of the mesh phase's M1 and on its nccl rank, K2 on each rank of its
S1 run).
The last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# bench.py:126-140 options (the bench configuration)
BENCH_OPTIONS = {
    "output_level": 0,
    "term.max_it": 60,
    "term.tol_opt": 1e-4,
    "chunk_size": 20,
    "history_capacity": 2,
    "kkt.it_refine_highprec": True,
}
# scripts/bench_large.py:49-52 options (the chain configuration)
CHAIN_OPTIONS = {
    "output_level": 0,
    "term.max_it": 200,
    "term.tol_opt": 1e-4,
    "chunk_size": 25,
    "history_capacity": 2,
}
CHAIN_SHAPE = {"K": 400, "nx": 32, "mc": 16}
# the banded path's reduced shape: small enough to detect the pattern from
# dense samples and to assemble a dense J and H (n = 1,600)
BANDED_SMALL_SHAPE = {"K": 50, "nx": 32, "mc": 16}
# the block band RCM gives CHAIN_SHAPE (bandwidth 63, a ragged last block and
# an identity tail); the banded run checks it, the kernel phase times it
BANDED_BAND = {"K": 204, "nb": 63}
# the mixed-precision phase: float64 solves of the dense QP at tol 1e-6
# with adaptive refinement on the pallas lane, with the factor in the solve
# dtype, in float32 (K1-K3 in float32 under the float64 solve), and on the
# fast-f64 lane (a float32 attempt redone in float64 where the strict pivot
# screen rejects it, Q formed in float32, the refinement's J products as
# float32 pairs: it_refine_highprec routes the refinement through them)
MIXED_SHAPE = {"n": 1024, "m": 512, "batch": 16}
MIXED_OPTIONS = {
    "output_level": 0,
    "term.max_it": 60,
    "term.tol_opt": 1e-6,
    "chunk_size": 20,
    "history_capacity": 2,
    "kkt.it_refine_adaptive": True,
}
MIXED_RUNS = {
    "same": {},
    "f32": {"kkt.factor_precision": "f32"},
    "f32_fallback": {"kkt.factor_precision": "f32_fallback",
                     "kkt.fallback_form_f32": True,
                     "kkt.hi_matvec_f32pair": "refine",
                     "kkt.it_refine_highprec": True},
}
# the instances the JAX package certifies on the CPU with MIXED_RUNS["f32"]
# (same problem, starts and options; tools/jax_dense_anchor.py): none, all
# 16 end at MAX_IT after 60 outer iterations
MIXED_JAX_F32_CERTIFIED = []
# the KKT-system phase: every KKT system of the dense driver in float64
# through BatchSolver at tol 1e-6.  The LP pool: tests/test_dual.py:19-29's
# recipe at KKT_LP_SHAPE, one LP a seed, on kkt_solver_type="schur_dual"
# and on "schur" with the pallas lane (K1-K3).  The bench QP at
# KKT_QP_SHAPE on each symmetric run of KKT_QP_RUNS (its batch beside it).
KKT_OPTIONS = {
    "output_level": 0,
    "term.max_it": 200,
    "term.tol_opt": 1e-6,
    "chunk_size": 25,
    "history_capacity": 2,
}
# 16 LPs, cut from 32 for the script's time limit
KKT_LP_SHAPE = {"n": 1024, "m": 512, "seeds": 16}
KKT_LP_PATHS = {
    "schur_dual": {"kkt.kkt_solver_type": "schur_dual"},
    "schur_pallas": {"kkt.linear_solver_type": "pallas"},
}
KKT_QP_SHAPE = {"n": 256, "m": 128}
KKT_QP_RUNS = {
    "symmetric": ({"kkt.kkt_solver_type": "symmetric"}, 8),
    "clever_symmetric": ({"kkt.kkt_solver_type": "clever_symmetric"}, 8),
    "clever_u_and_x": ({"kkt.kkt_solver_type": "clever_symmetric",
                        "kkt.kkt_system_rescale": "u_and_x"}, 8),
    "symmetric_eigh": ({"kkt.kkt_solver_type": "symmetric",
                        "kkt.linear_solver_type": "eigh"}, 4),
}
# the LP pool's objective agreement between its two paths: tol_opt, since
# the JAX package's own pool misses 1e-7 (PERF.md, the kkt phase)
KKT_LP_OBJ_RTOL = 1e-6
# runs whose endgame round-off decides (ROADMAP R5): on the dual path the
# Woodbury form's cancellation leaves the direction with an a-posteriori
# KKT error of 1e-7..4e-2, and the JAX package's own drivers end one LP in
# different outer iterations (11, 37, 11, 12 on tests/test_dual.py's seed
# 0), so only its statuses are held
KKT_ROUNDOFF = ("schur_dual",)
# the JAX package's figures for the same data and options on the CPU
# (tools/jax_kkt_anchor.py): per run, the statuses, and the outer
# iterations and factorizations in sum; mr of the QP runs; the LP pool's
# objective gap between its paths (`--runs schur_dual --seeds 16` and
# `--runs schur_pallas --seeds 16`)
KKT_JAX_ANCHOR = {
    "schur_dual": {"statuses": ["Optimal"] * 16, "outer_its_sum": 750,
                   "cum_fac_sum": 1159},
    "schur_pallas": {"statuses": ["Optimal"] * 16, "outer_its_sum": 317,
                     "cum_fac_sum": 333},
    "symmetric": {"statuses": ["Optimal"] * 8, "outer_its_sum": 88,
                  "cum_fac_sum": 96, "mr": 768},
    "clever_symmetric": {"statuses": ["Optimal"] * 8, "outer_its_sum": 88,
                         "cum_fac_sum": 96, "mr": 384},
    "clever_u_and_x": {"statuses": ["Optimal"] * 8, "outer_its_sum": 88,
                       "cum_fac_sum": 96, "mr": 384},
    "symmetric_eigh": {"statuses": ["Optimal"] * 4, "outer_its_sum": 44,
                       "cum_fac_sum": 48, "mr": 768},
    "lp_obj_gap_max": 2.58996624407483e-07,
    "lp_obj_gap_within_1e-7": 6,
}
# the scenario phase: the arrow-KKT path (ScenarioKernel), each run from
# its start to termination.  S1: scripts/bench_scenario.py's shape and dtype
# (flat n = 16,400, float32, tol 1e-4) on the pallas lane (K2 on the scenario blocks
# and the border) and the xla lane; S2: the JAX scale test's shape
# (tests/test_scenario.py:110-148) in float64 on the arrow path against the
# dense path of the flat NLP (K1-K3); S3: the multichip dryrun's ECON leg
# (__graft_entry__.py:77-87: tax_grouped, 64 groups of 8 agent types,
# max_it 160, chunk_size 40) on one card, arrow against dense; S4: ECON50
# and the six examples of scripts/run_examples.py:55-60 on the dense path
# in float64 at tol 1e-6 (its options).
SCEN_OPTIONS = {
    "output_level": 0,
    "term.max_it": 200,
    "chunk_size": 25,
    "history_capacity": 2,
}
SCEN_S1 = {"K": 256, "nz": 16, "nx": 64, "mc": 32}
# float32 at tol 1e-4, the float32 tolerance of bench.py and
# scripts/bench_large.py: at the default 1e-6 the float32 run ends at
# MAX_IT (200 outer iterations on the card)
SCEN_S1_OPTIONS = dict(SCEN_OPTIONS, **{"term.tol_opt": 1e-4})
SCEN_S2 = {"K": 64, "nz": 16, "nx": 64, "mc": 32}
SCEN_S3 = {"G": 64, "na_g": 8, "wage_spread": "banded"}
SCEN_S3_OPTIONS = dict(SCEN_OPTIONS, **{"term.max_it": 160,
                                        "chunk_size": 40})
SCEN_S4_OPTIONS = {"output_level": 0, "term.max_it": 600, "chunk_size": 50,
                   "history_capacity": 2}
SCEN_S4 = {
    "ECON50": ("tax", "tax1d", (50,)),
    "kissing12d3": ("examples", "kissing", (12, 3)),
    "kissing25d4": ("examples", "kissing", (25, 4)),
    "polygon20": ("examples", "largest_small_polygon", (20,)),
    "electron25": ("examples", "electron", (25,)),
    "maxcut30": ("examples", "max_cut", (30, 5)),
    "chain50": ("examples", "chain", (50,)),
}
# the arrow and dense runs of S2 and S3 agree: status, argmin to this
# (relative to max |x|) and outer iterations within one, but on the runs of
# SCEN_ROUNDOFF (ROADMAP R5): S3's start puts s y / mu of its clamped rows
# on the comp_feas_agg bound (center_dual), so rounding decides the first
# switching test and with it the trajectory; the JAX package's own arrow
# and dense runs end in 98 and 104 outer iterations
SCEN_X_RTOL = 1e-6
SCEN_ROUNDOFF = ("S3",)
# K2 at the scenario path's shapes: (B K, n) of S1's blocks, S3's blocks,
# S3's border batched, and one 1 x 1 border
SCEN_CHOL_SHAPES = ((256, 64), (64, 16), (64, 1), (1, 1))
# the JAX package's figures for the same data, options and dtype on the CPU
# (tools/jax_scenario_anchor.py): status, outer iterations, factorizations
SCEN_JAX_ANCHOR = {
    "S1": {"status": "Optimal", "outer_its": 11, "cum_fac": 12},
    "S2_arrow": {"status": "Optimal", "outer_its": 13, "cum_fac": 14},
    "S2_dense": {"status": "Optimal", "outer_its": 13, "cum_fac": 14},
    "S3_arrow": {"status": "Optimal", "outer_its": 98, "cum_fac": 174},
    "S3_dense": {"status": "Optimal", "outer_its": 104, "cum_fac": 180},
    "ECON50": {"status": "Optimal", "outer_its": 84, "cum_fac": 116},
    "kissing12d3": {"status": "Optimal", "outer_its": 52, "cum_fac": 122},
    "kissing25d4": {"status": "Optimal", "outer_its": 184, "cum_fac": 459},
    "polygon20": {"status": "Optimal", "outer_its": 17, "cum_fac": 38},
    "electron25": {"status": "Optimal", "outer_its": 28, "cum_fac": 49},
    "maxcut30": {"status": "Optimal", "outer_its": 24, "cum_fac": 60},
    "chain50": {"status": "Optimal", "outer_its": 123, "cum_fac": 255},
}
# the campaign phase: shape-bucketed parametric LP batches
# (parallel/buckets.solve_bucketed), float32 with one float64 escalation
# pass on the card.  C1: the throughput-crossover record's n=1024 dense
# row (scripts/run_throughput_crossover.py:44-56, its options :138-158) on
# the pallas lane, one shape class of 32 LPs, each with its own A; C2: the
# first 48 instances of results/mixed_parity_lanes.md's mixed pool with
# scripts/run_mixed_lanes.py's options; C3: seven small MPS files of
# results/lpi_mps/ through harness.run_lp_directory (scripts/run_lpi.py's
# options), then the CLI twice into one directory (the second resumes)
CAMP_OPTIONS = {
    "output_level": 0, "term.max_it": 120, "term.tol_opt": 1e-4,
    "term.tol_inf_2": 1e-3, "chunk_size": 25,
    "kkt.linear_solver_type": "pallas",
    "kkt.it_refine_adaptive": True, "kkt.it_refine_max": 8,
    "kkt.it_refine_tol": 5e-7, "kkt.it_refine_highprec": True,
    "term.stall_patience": 25,
}
# C1 and C2 at half their records' pools (16 of 32 and 24 of 48 pairs):
# the first pairs of the same suites, so every instance keeps its
# CAMP_JAX_ANCHOR entry.  Cut for the 1200 s limit: one tree of
# this script ran 1.23x slower on one H100 host than on another, every
# phase 1.2-1.5x (PERF.md, section 5)
CAMP_C1 = {"n": 1024, "m": 512, "n_pairs": 16, "density": 0.5}
CAMP_C2 = {"n_pairs": 24, "max_n": 600}
CAMP_C2_OPTIONS = dict(CAMP_OPTIONS, **{"term.max_it": 200})
CAMP_ROUND_TO = 128
CAMP_C3_FILES = ("galenet", "itest2", "itest6", "bgprtr", "woodinfe",
                 "klein1", "forest6")
CAMP_C3_OPTIONS = {
    "output_level": 0, "term.max_it": 120, "term.tol_opt": 1e-4,
    "term.tol_inf_2": 1e-3, "chunk_size": 25,
    "kkt.linear_solver_type": "pallas", "kkt.it_refine_highprec": True,
    "term.max_time": 600.0,
}
# an Optimal feasible member's objective against HiGHS's
# (scripts/run_mixed_parity.py:124-129)
CAMP_OBJ_RTOL = 5e-3
# the JAX package's figures for the same pools and options on the CPU
# (tools/jax_campaign_anchor.py): per instance, its float64 status,
# objective and outer iterations under the escalation pass's options
# (term.max_it 80), and HiGHS's objective of each feasible member
CAMP_JAX_ANCHOR = {
    "C1": {
        "mix1024_0_feas": (
            "Optimal", -2230.947964445202, 18, -2230.990299526675),
        "mix1024_0_infeas": (
            "primal_infeasible", 147.8438150672009, 27, None),
        "mix1024_10_feas": (
            "Optimal", -1994.07378963598, 17, -1994.1067821529598),
        "mix1024_10_infeas": (
            "primal_infeasible", 65.9761425779092, 36, None),
        "mix1024_11_feas": (
            "Optimal", -2192.707366480132, 17, -2192.729489213822),
        "mix1024_11_infeas": (
            "primal_infeasible", -1743.8120727618111, 22, None),
        "mix1024_12_feas": (
            "Optimal", -2108.652046216346, 17, -2108.680147779838),
        "mix1024_12_infeas": (
            "primal_infeasible", 90.55469181521224, 27, None),
        "mix1024_13_feas": (
            "Optimal", -1842.7256921944888, 17, -1842.7682160936738),
        "mix1024_13_infeas": (
            "primal_infeasible", -1277.0282437492506, 8, None),
        "mix1024_14_feas": (
            "Optimal", -2329.4575919976305, 17, -2329.509990803256),
        "mix1024_14_infeas": (
            "primal_infeasible", 53.309089951800075, 36, None),
        "mix1024_15_feas": (
            "Optimal", -2139.9328977295922, 17, -2139.9742561072376),
        "mix1024_15_infeas": (
            "primal_infeasible", -2078.5507330549817, 24, None),
        "mix1024_16_feas": (
            "Optimal", -2197.3597269280417, 16, -2197.4053526922703),
        "mix1024_16_infeas": (
            "primal_infeasible", -26.78917896080158, 26, None),
        "mix1024_17_feas": (
            "Optimal", -2077.927993283051, 18, -2077.9660904740417),
        "mix1024_17_infeas": (
            "primal_infeasible", -1245.108985046242, 8, None),
        "mix1024_18_feas": (
            "Optimal", -2157.736138062773, 17, -2157.771755556191),
        "mix1024_18_infeas": (
            "primal_infeasible", 30.856209604626557, 36, None),
        "mix1024_19_feas": (
            "Optimal", -2050.3518554441284, 17, -2050.391581362737),
        "mix1024_19_infeas": (
            "primal_infeasible", -1674.3866215381595, 21, None),
        "mix1024_1_feas": (
            "Optimal", -2336.515201374753, 17, -2336.5594505798354),
        "mix1024_1_infeas": (
            "primal_infeasible", -1412.466852764577, 9, None),
        "mix1024_20_feas": (
            "Optimal", -2021.0827976325854, 17, -2021.1481777571587),
        "mix1024_20_infeas": (
            "primal_infeasible", -200.6824606444878, 29, None),
        "mix1024_21_feas": (
            "Optimal", -2047.4511106692482, 17, -2047.479774458434),
        "mix1024_21_infeas": (
            "primal_infeasible", -1375.4269487517392, 8, None),
        "mix1024_22_feas": (
            "Optimal", -2206.5828039465937, 17, -2206.621273301349),
        "mix1024_22_infeas": (
            "primal_infeasible", 68.56367782848885, 38, None),
        "mix1024_23_feas": (
            "Optimal", -1982.687128402565, 18, -1982.7514148040152),
        "mix1024_23_infeas": (
            "primal_infeasible", -1579.6620157654688, 22, None),
        "mix1024_24_feas": (
            "Optimal", -2400.024087797983, 17, -2400.0717510308555),
        "mix1024_24_infeas": (
            "primal_infeasible", 5.365391762840145, 26, None),
        "mix1024_25_feas": (
            "Optimal", -2374.953415537856, 18, -2374.9960574222528),
        "mix1024_25_infeas": (
            "primal_infeasible", -1046.4336180707012, 8, None),
        "mix1024_26_feas": (
            "Optimal", -2250.0585472708526, 18, -2250.1123718363833),
        "mix1024_26_infeas": (
            "primal_infeasible", 16.55498944633875, 37, None),
        "mix1024_27_feas": (
            "Optimal", -2283.282522063369, 17, -2283.324748660911),
        "mix1024_27_infeas": (
            "primal_infeasible", -2258.521374201002, 25, None),
        "mix1024_28_feas": (
            "Optimal", -2310.048199304344, 17, -2310.07866900103),
        "mix1024_28_infeas": (
            "primal_infeasible", -168.85041938019518, 28, None),
        "mix1024_29_feas": (
            "Optimal", -2330.162070329459, 17, -2330.196452348521),
        "mix1024_29_infeas": (
            "primal_infeasible", -1155.714231646649, 8, None),
        "mix1024_2_feas": (
            "Optimal", -1925.679132710181, 17, -1925.7081929776),
        "mix1024_2_infeas": (
            "primal_infeasible", 65.2176301200429, 35, None),
        "mix1024_30_feas": (
            "Optimal", -2445.667000068395, 17, -2445.697040822692),
        "mix1024_30_infeas": (
            "primal_infeasible", 56.77135779182514, 36, None),
        "mix1024_31_feas": (
            "Optimal", -2074.1765092739893, 17, -2074.2338653511106),
        "mix1024_31_infeas": (
            "primal_infeasible", -1705.2084183521606, 24, None),
        "mix1024_3_feas": (
            "Optimal", -1868.8749774286289, 18, -1868.9032490327722),
        "mix1024_3_infeas": (
            "primal_infeasible", -1685.3092635628013, 21, None),
        "mix1024_4_feas": (
            "Optimal", -1918.4526336107965, 17, -1918.4819869306523),
        "mix1024_4_infeas": (
            "primal_infeasible", -72.5864858276141, 26, None),
        "mix1024_5_feas": (
            "Optimal", -2042.1844283556247, 17, -2042.2295464549459),
        "mix1024_5_infeas": (
            "primal_infeasible", -1103.0120014401512, 8, None),
        "mix1024_6_feas": (
            "Optimal", -2148.6795158647524, 18, -2148.7158094435354),
        "mix1024_6_infeas": (
            "primal_infeasible", -32.87652389751722, 39, None),
        "mix1024_7_feas": (
            "Optimal", -2069.2673539372677, 16, -2069.3247525738493),
        "mix1024_7_infeas": (
            "primal_infeasible", -1396.6423450420505, 22, None),
        "mix1024_8_feas": (
            "Optimal", -2413.159632550417, 18, -2413.2111208202823),
        "mix1024_8_infeas": (
            "primal_infeasible", 125.35765423886582, 27, None),
        "mix1024_9_feas": (
            "Optimal", -2127.7317285006, 17, -2127.7703086105626),
        "mix1024_9_infeas": (
            "primal_infeasible", -1445.4722269278577, 9, None),
    },
    "C2": {
        "lpi_bgdbg1_0_feas": (
            "Optimal", -619.590214669496, 14, -619.5986976337863),
        "lpi_bgdbg1_0_infeas": (
            "primal_infeasible", 313.39595548289475, 23, None),
        "lpi_bgdbg1_17_feas": (
            "Optimal", -617.6792367640397, 15, -617.6821677980247),
        "lpi_bgdbg1_17_infeas": (
            "primal_infeasible", -375.77730518556604, 7, None),
        "lpi_bgdbg1_34_feas": (
            "Optimal", -572.1971424347397, 15, -572.2053496929626),
        "lpi_bgdbg1_34_infeas": (
            "primal_infeasible", 5.017861985256398, 43, None),
        "lpi_bgprtr_18_feas": (
            "Optimal", -74.12142235136687, 9, -74.12166798051346),
        "lpi_bgprtr_18_infeas": (
            "primal_infeasible", 19.190817534681887, 32, None),
        "lpi_bgprtr_1_feas": (
            "Optimal", -96.02548795997699, 9, -96.02621078840642),
        "lpi_bgprtr_1_infeas": (
            "primal_infeasible", -62.58225581332473, 5, None),
        "lpi_bgprtr_35_feas": (
            "Optimal", -51.29798283918353, 9, -51.29852133892623),
        "lpi_bgprtr_35_infeas": (
            "primal_infeasible", -10.424591265746196, 20, None),
        "lpi_box1_19_feas": (
            "Optimal", -334.3206503135674, 14, -334.3210834151286),
        "lpi_box1_19_infeas": (
            "primal_infeasible", -231.9330482294349, 22, None),
        "lpi_box1_2_feas": (
            "Optimal", -347.41061638328233, 14, -347.41319359325456),
        "lpi_box1_2_infeas": (
            "primal_infeasible", 1.7700426010081194, 37, None),
        "lpi_box1_36_feas": (
            "Optimal", -340.2530488051556, 14, -340.2545257164393),
        "lpi_box1_36_infeas": (
            "primal_infeasible", 31.751157739438234, 20, None),
        "lpi_ex72a_20_feas": (
            "Optimal", -261.052620251126, 14, -261.0553854766767),
        "lpi_ex72a_20_infeas": (
            "primal_infeasible", -37.667779674434215, 22, None),
        "lpi_ex72a_37_feas": (
            "Optimal", -213.1201326701884, 14, -213.12209926208547),
        "lpi_ex72a_37_infeas": (
            "primal_infeasible", -168.971425797076, 6, None),
        "lpi_ex72a_3_feas": (
            "Optimal", -334.9504535394942, 14, -334.9524611128589),
        "lpi_ex72a_3_infeas": (
            "primal_infeasible", -287.342175904345, 22, None),
        "lpi_ex73a_21_feas": (
            "Optimal", -465.24615144937746, 13, -465.24996765322675),
        "lpi_ex73a_21_infeas": (
            "primal_infeasible", -171.5041314230676, 7, None),
        "lpi_ex73a_38_feas": (
            "Optimal", -334.7051759608414, 13, -334.70877068445503),
        "lpi_ex73a_38_infeas": (
            "primal_infeasible", -11.87685601829342, 35, None),
        "lpi_ex73a_4_feas": (
            "Optimal", -267.82736769786493, 13, -267.8306633850743),
        "lpi_ex73a_4_infeas": (
            "primal_infeasible", -90.29963627004021, 20, None),
        "lpi_forest6_22_feas": (
            "Optimal", -203.7825421223898, 12, -203.7849120707316),
        "lpi_forest6_22_infeas": (
            "primal_infeasible", -4.682803714139486, 32, None),
        "lpi_forest6_39_feas": (
            "Optimal", -186.55064056012995, 12, -186.5535889582332),
        "lpi_forest6_39_infeas": (
            "primal_infeasible", -114.59314262036492, 22, None),
        "lpi_forest6_5_feas": (
            "Optimal", -227.00915488037927, 11, -227.00964705497287),
        "lpi_forest6_5_infeas": (
            "primal_infeasible", -136.87304002578108, 6, None),
        "lpi_galenet_23_feas": (
            "Optimal", -34.54966438007946, 7, -34.54958306314743),
        "lpi_galenet_23_infeas": (
            "primal_infeasible", -14.679663693598247, 22, None),
        "lpi_galenet_40_feas": (
            "Optimal", -2.083999110308015, 8, -2.0839219101862563),
        "lpi_galenet_40_infeas": (
            "primal_infeasible", 8.132223245320864, 10, None),
        "lpi_galenet_6_feas": (
            "Optimal", -5.818589433991047, 6, -5.818566589092984),
        "lpi_galenet_6_infeas": (
            "primal_infeasible", -2.661077782503318, 24, None),
        "lpi_itest2_24_feas": (
            "Optimal", 5.834776142551985, 8, 5.835015405084105),
        "lpi_itest2_24_infeas": (
            "primal_infeasible", 6.016775796463325, 10, None),
        "lpi_itest2_41_feas": (
            "Optimal", 5.355397400216694, 6, 5.355463036542318),
        "lpi_itest2_41_infeas": (
            "primal_infeasible", -1.567663765039085, 6, None),
        "lpi_itest2_7_feas": (
            "Optimal", -3.7265391416405613, 9, -3.726196516406259),
        "lpi_itest2_7_infeas": (
            "primal_infeasible", -3.040374368055125, 20, None),
        "lpi_itest6_25_feas": (
            "Optimal", 5.79901190348546, 8, 5.799018987408456),
        "lpi_itest6_25_infeas": (
            "primal_infeasible", -4.424149423243778, 7, None),
        "lpi_itest6_42_feas": (
            "Optimal", -2.0325691398981034, 7, -2.0325694198993167),
        "lpi_itest6_42_infeas": (
            "primal_infeasible", -0.615456532728266, 24, None),
        "lpi_itest6_8_feas": (
            "Optimal", -5.919874133807862, 8, -5.9197886682836245),
        "lpi_itest6_8_infeas": (
            "primal_infeasible", -2.9478090662108998, 13, None),
        "lpi_klein1_26_feas": (
            "Optimal", -40.89212252606896, 10, -40.892247353913355),
        "lpi_klein1_26_infeas": (
            "primal_infeasible", 12.695204273335913, 31, None),
        "lpi_klein1_43_feas": (
            "Optimal", -42.205051273751785, 12, -42.204733269396804),
        "lpi_klein1_43_infeas": (
            "primal_infeasible", -120.83388325398144, 21, None),
        "lpi_klein1_9_feas": (
            "Optimal", -47.30273313899784, 10, -47.30237841880369),
        "lpi_klein1_9_infeas": (
            "primal_infeasible", -23.967740764680915, 6, None),
        "lpi_klein2_10_feas": (
            "Optimal", -14.072301498785572, 5, -14.072321919134804),
        "lpi_klein2_10_infeas": (
            "primal_infeasible", -0.9511135122570494, 37, None),
        "lpi_klein2_27_feas": (
            "Optimal", 17.470557412284037, 6, 17.470557796539694),
        "lpi_klein2_27_infeas": (
            "primal_infeasible", -20.0086872795978, 24, None),
        "lpi_klein2_44_feas": (
            "Optimal", 3.1588005618524733, 7, 3.1588064101191),
        "lpi_klein2_44_infeas": (
            "primal_infeasible", 10.989435514233687, 19, None),
        "lpi_klein3_11_feas": (
            "Optimal", 61.01813209490135, 7, 61.0183362229601),
        "lpi_klein3_11_infeas": (
            "primal_infeasible", 16.936407961293153, 22, None),
        "lpi_klein3_28_feas": (
            "Optimal", 31.945351538632757, 6, 31.945337505397266),
        "lpi_klein3_28_infeas": (
            "primal_infeasible", 23.463496131929297, 21, None),
        "lpi_klein3_45_feas": (
            "Optimal", -44.82649851920681, 7, -44.82649617963823),
        "lpi_klein3_45_infeas": (
            "primal_infeasible", 2.447484071084862, 9, None),
        "lpi_pang_12_feas": (
            "Optimal", -660.7353396818077, 15, -660.7407989061102),
        "lpi_pang_12_infeas": (
            "primal_infeasible", 149.56710003813546, 26, None),
        "lpi_pang_29_feas": (
            "Optimal", -812.2729434714319, 14, -812.2826405282946),
        "lpi_pang_29_infeas": (
            "primal_infeasible", -190.4151549184783, 6, None),
        "lpi_pang_46_feas": (
            "Optimal", -774.699030056334, 15, -774.7077157608159),
        "lpi_pang_46_infeas": (
            "primal_infeasible", 1.1795736242127892, 46, None),
        "lpi_qual_13_feas": (
            "Optimal", -934.8962155528671, 14, -934.904395975563),
        "lpi_qual_13_infeas": (
            "primal_infeasible", -545.7820052340857, 8, None),
        "lpi_qual_30_feas": (
            "Optimal", -801.8428145784039, 14, -801.8603121967775),
        "lpi_qual_30_infeas": (
            "primal_infeasible", -14.354125474022707, 42, None),
        "lpi_qual_47_feas": (
            "Optimal", -827.121394030212, 14, -827.1355803552334),
        "lpi_qual_47_infeas": (
            "primal_infeasible", -458.99473392082234, 22, None),
        "lpi_refinery_14_feas": (
            "Optimal", -754.7821244764202, 16, -754.7895364633788),
        "lpi_refinery_14_infeas": (
            "primal_infeasible", 28.783135620220552, 45, None),
        "lpi_refinery_31_feas": (
            "Optimal", -899.7680260572955, 14, -899.780764900745),
        "lpi_refinery_31_infeas": (
            "primal_infeasible", -569.1785419010337, 22, None),
        "lpi_vol1_15_feas": (
            "Optimal", -911.4893923599166, 15, -911.4975653408696),
        "lpi_vol1_15_infeas": (
            "primal_infeasible", -733.5965957324819, 23, None),
        "lpi_vol1_32_feas": (
            "Optimal", -807.0621327855897, 15, -807.0771116862642),
        "lpi_vol1_32_infeas": (
            "primal_infeasible", 236.8743532798196, 23, None),
        "lpi_woodinfe_16_feas": (
            "Optimal", -201.2123719873475, 11, -201.21420884405606),
        "lpi_woodinfe_16_infeas": (
            "primal_infeasible", 20.606904206114915, 17, None),
        "lpi_woodinfe_33_feas": (
            "Optimal", -207.39662227199688, 11, -207.39811446456787),
        "lpi_woodinfe_33_infeas": (
            "primal_infeasible", -63.78009775621329, 6, None),
    },
}
TOL ={"float32": 1e-4, "float64": 1e-10}   # max error / max |reference|
REPS = 20
# H100 SXM (NVIDIA's data sheet, dense, at 700 W): HBM3 bytes/s, and the
# FLOP/s of each type: float32 outside the tensor cores, float64 on the
# FP64 tensor cores, the rate cuBLAS's DGEMM reaches (the FP64 cores
# alone give 34 TFLOP/s)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
# the tensor cores' dense rates for a matmul mode's input type: a mode's
# products are products of that type (K1's and K2's trailing update run
# them on the tensor cores; K3's inverse, K5 and K7 on the FP32 cores)
PEAK_FLOPS_MODE = {"tf32": 495e12, "bf16": 989e12, "f16": 989e12}
DNAME = {4: "float32", 8: "float64"}    # by element size
# cycles from one FMA's issue to its dependent's (FP32 on Hopper), the unit
# of the block-tridiagonal kernels' dependence bounds
FMA_LATENCY_CYCLES = 4


def _bound(nbytes, flops, dname="float32"):
    """(bound_ms, bound_by): the least time for `nbytes` moved (each input
    read once, each output written once) and `flops` done, the larger of
    bytes over the memory rate and operations over the peak rate of
    `dname` (a dtype's name, or a matmul mode's input type)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / {**PEAK_FLOPS, **PEAK_FLOPS_MODE}[dname] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _baddbmm_operands(Jc, w, H, B):
    """The library yardstick's operands, prepared outside any timed region:
    torch.baddbmm(Hb, A, Jb) = H + (Jc w)^T Jc, one cuBLAS batched product
    (the rank-m body plus H; diag(bnd) is the one part it leaves out)."""
    import torch
    m, n = Jc.shape[-2:]
    A = (Jc * w[:, :, None]).transpose(-1, -2).contiguous()
    Jb = Jc.expand(B, m, n).contiguous()
    Hb = torch.zeros(B, n, n, dtype=Jc.dtype, device=Jc.device) \
        if H is None else H.expand(B, n, n)
    return Hb, A, Jb


def _fused_q_bound(B, m, n, el):
    """The bound of K1 and K6 with a shared Jc and H: Jc, w, H, bnd read
    once, Q written once; Q is symmetric, so its n (n + 1) / 2 distinct
    entries of length m take B m n (n + 1) operations (K1 forms the full Q,
    2 B m n^2; K6 just the triangle)."""
    nbytes = el * (m * n + B * m + n * n + B * n + B * n * n)
    return _bound(nbytes, B * m * n * (n + 1), DNAME[el])


def _sm_max_hz() -> float:
    """The card's highest SM clock (nvidia-smi's clocks.max.sm), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def _device_ms(fn, name) -> float:
    """Mean device time of what `name` names, over REPS calls of `fn`
    traced by torch.profiler: a CUDA kernel whose name holds `name` (a
    launch's mean), or an aten operator ("aten::baddbmm": every kernel it
    launched, a call's mean, the host traced too so that each kernel is
    tied to the operator that launched it and no kernel of earlier work
    counts).  A trace can miss the card's activity altogether: then it is
    traced again, the host too, and where three traces saw none of it a
    call's device time is read from CUDA events instead (`_queued_ms`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    op = name.startswith("aten::")
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        acts = [ProfilerActivity.CUDA]
        if op or attempt:
            acts.append(ProfilerActivity.CPU)
        with profile(activities=acts) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        total, count, seen = 0.0, 0, set()
        for ev in prof.key_averages():
            if not getattr(ev, "device_time_total", 0):
                continue
            seen.add(ev.key[:80])
            if (ev.key == name) if op else (name in ev.key):
                total += ev.device_time_total
                count += ev.count
        if count and total:
            return total / count / 1e3
    ms = _queued_ms(fn)
    print(f"torch.profiler saw no {name} in 3 traces (the last saw "
          f"{sorted(seen)}): {ms:.4f} ms a call from CUDA events "
          "(`_queued_ms`)", flush=True)
    return ms


def _queued_ms(fn) -> float:
    """Device milliseconds a call of `fn` from CUDA events: REPS calls
    queued behind a spin kernel (torch.cuda._sleep), so that the card runs
    them back to back and no host work between them shows; the spin is
    lengthened up to about half a second.  A call that waits for the card
    itself (cholesky_ex may) never queues: then the median of REPS calls,
    each between two events (`_time_ms`)."""
    import torch
    cycles = 1 << 24
    for _ in range(4):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        t0.record()
        for _ in range(REPS):
            fn()
        t1.record()
        queued = not t0.query()
        torch.cuda.synchronize()
        if queued:
            return t0.elapsed_time(t1) / REPS
        cycles *= 4
    return _time_ms(fn)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _spd(rng, B, n, dtype, device):
    """A A^T + n I with A from the seeded numpy generator (formed on the
    card in float64)."""
    import torch
    A = torch.as_tensor(rng.normal(size=(B, n, n)), dtype=torch.float64,
                        device=device)
    Q = A @ A.transpose(-1, -2) + n * torch.eye(n, dtype=torch.float64,
                                                device=device)
    return Q.to(dtype)


def _err(got, ref):
    """(max |got - ref| / max |ref|, max |got - ref|)."""
    ref = ref.double()
    diff = float((got.double() - ref).abs().max())
    return diff / float(ref.abs().max()), diff


def _time_turns(*fns, reps=REPS) -> list:
    """Medians of `reps` launches of each function, the functions taken in
    turns (f, g, f, g, ...), each launch between two CUDA events: two
    versions compared on one card under the same conditions."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end))
    return [float(np.median(ts)) for ts in times]


def _time_ms(fn) -> float:
    """Median of REPS launches, each between two CUDA events."""
    return _time_turns(fn)[0]


def _ptxas_report(log, kernels):
    """The -Xptxas -v lines (registers, shared memory, spills) of every
    instantiation of the named kernels in the build log, and each
    source's compile seconds."""
    out, current = [], None
    for ln in log.splitlines():
        head = re.match(r"^(\S+\.cu) \(([\d.]+) s\):$", ln)
        if head:
            out.append(f"{head.group(1)}: nvcc {head.group(2)} s")
            current = None
        elif "Compiling entry function" in ln:
            current = next((k for k in kernels if k in ln), None)
            if current:
                # the template arguments of the mangled name: the type
                # where there is one, then the integers (tile edge, thread
                # count, mode kind and passes, ...) and flags
                args = ln.split(current, 1)[1].split("EEv")[0]
                targs = ([{"f": "float", "d": "double"}[args[1]]]
                         if args[1:2] in ("f", "d") else [])
                targs += [v if kind == "i" else ("true" if v == "1" else
                                                 "false")
                          for kind, v in re.findall(r"L([ib])(\d+)E", args)]
                out.append(f"{current}<{', '.join(targs)}>")
        elif current and ("registers" in ln or "spill" in ln):
            out.append("    " + ln.strip().replace("ptxas info    : ", ""))
    return out


# the kernels that must not spill a register: K1's, K2's and K3's (the
# dense KKT path's Q formation, factorization and finalize); the build's
# other spills are printed (tridiag_factor_kernel<double, 64, 512> spills
# 52 bytes, ROADMAP)
SPILL_FREE = ("fused_q_lower_kernel", "fused_q_dmma_kernel",
              "fused_q_wg_kernel", "fused_q_tc_kernel", "chol_kernel",
              "tri_inv_kernel", "tri_inv_mode_kernel")


def _no_spills(log, kernels=SPILL_FREE):
    """Raise if ptxas reports a spill in an instantiation of `kernels` in
    the build log; print every other function that spills (mangled
    names).  An empty log (the library was built before this process)
    is said to be unchecked."""
    if not log:
        print("ptxas: spills not checked (the library was built before "
              "this run, so there is no build log)", flush=True)
        return
    spills, current = [], None
    for ln in log.splitlines():
        head = re.search(r"Function properties for (\w+)", ln)
        if head:
            current = head.group(1)
        elif re.search(r"[1-9]\d* bytes spill (stores|loads)", ln):
            spills.append((current, ln.split(":", 1)[-1].strip()))
    bad = [f"{f}: {v}" for f, v in spills
           if any(f"{len(k)}{k}" in f for k in kernels)]
    if bad:
        raise RuntimeError("K1/K2/K3 kernels spill registers: "
                           + "; ".join(bad))
    print("ptxas: no K1, K2 or K3 kernel spills a register"
          + ("" if not spills else "; others: " + "; ".join(
              f"{f}: {v}" for f, v in spills)), flush=True)


def kernel_routes(dev):
    """The float64 launches of K1, K6 and K3's Gram half run the FP64
    tensor-core instantiation (`fused_q_dmma_kernel`), and K3's moded
    inverse its own (`tri_inv_mode_kernel`): torch.profiler's kernel names,
    with each one's mean device time over REPS calls at 256/128/16 (raises
    where the profiler sees no such kernel)."""
    import torch
    from onephase_tpu_torch.ops import cholesky as ch
    from onephase_tpu_torch.ops import precision, schur
    rng = np.random.default_rng(11)
    n, m, B = 256, 128, 16
    f64 = torch.float64
    Jc = torch.as_tensor(rng.normal(size=(m, n)) / np.sqrt(n), dtype=f64,
                         device=dev)
    w = torch.as_tensor(rng.uniform(0.1, 10.0, size=(B, m)), dtype=f64,
                        device=dev)
    H = _spd(rng, 1, n, f64, dev)[0]
    bnd = torch.as_tensor(rng.uniform(0.0, 5.0, size=(B, n)), dtype=f64,
                          device=dev)
    L64 = ch.pallas_chol(_spd(rng, B, n, f64, dev))[0]
    L32 = ch.pallas_chol(_spd(rng, B, n, torch.float32, dev))[0]
    parts = []
    for label, fn, kernel in (
            ("K1 f64", lambda: schur.pallas_fused_q(Jc, w, H, bnd),
             "fused_q_dmma_kernel"),
            ("K6 f64", lambda: schur.pallas_fused_q_tri(Jc, w, H, bnd),
             "fused_q_dmma_kernel"),
            ("K3 f64 (its Gram half)", lambda: ch.pallas_tri_inv_gram(L64),
             "fused_q_dmma_kernel"),
            ("K3 bf16_x6 (its inverse)",
             lambda: ch.pallas_tri_inv_gram(L32, mode=precision.Mode(
                 "bf16", 6)), "tri_inv_mode_kernel")):
        parts.append(f"{label}: {kernel} {_device_ms(fn, kernel):.4f} ms")
    print(f"kernel routes (torch.profiler, n={n} m={m} B={B}): "
          + "; ".join(parts), flush=True)


# the launch path: calls a round, back to back, ended by one synchronize
LAUNCH_CALLS = 200


def host_call_ms(*fns, calls=LAUNCH_CALLS, rounds=REPS) -> list:
    """Medians over `rounds` of the wall milliseconds a call of each
    function takes, `calls` calls back to back ended by one synchronize,
    the functions in turns (a, b, ..., b, a): what a caller that does not
    wait pays a call, the host's work where it exceeds the device's."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    order = list(range(len(fns)))
    order += order[::-1]
    times = [[] for _ in fns]
    for _ in range(rounds):
        for i in order:
            t0 = time.perf_counter()
            for _ in range(calls):
                fns[i]()
            torch.cuda.synchronize()
            times[i].append((time.perf_counter() - t0) / calls * 1e3)
    return [float(np.median(ts)) for ts in times]


def launch_path_cases(dev, trees):
    """The launch path's cases: K1 at the bench QP's 256/128/16 (a shared
    Jc and H) in float32 and float64 beside `baddbmm`, K2 at 256/16 and at
    the scenario shapes (SCEN_CHOL_SHAPES) in both beside `cholesky_ex`.
    `trees` maps a label to a tree's (ops.schur, ops.cholesky); returns
    [(case, {label: fn}, library fn, the kernel's name for the profiler,
    the library call's aten operator)] on one set of operands a case."""
    import torch
    rng = np.random.default_rng(13)
    n, m, B = PREC_BENCH_SHAPE
    cases = []
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        Jc = torch.as_tensor(rng.normal(size=(m, n)) / np.sqrt(n),
                             dtype=dtype, device=dev)
        w = torch.as_tensor(rng.uniform(0.1, 10.0, size=(B, m)), dtype=dtype,
                            device=dev)
        H = _spd(rng, 1, n, dtype, dev)[0]
        bnd = torch.as_tensor(rng.uniform(0.0, 5.0, size=(B, n)),
                              dtype=dtype, device=dev)
        Hb, A, Jb = _baddbmm_operands(Jc, w, H, B)
        ops = (Jc, w, H, bnd)
        cases.append((
            f"K1 {dname} {n}/{m}/{B}",
            {k: (lambda sc=sc, ops=ops: sc.pallas_fused_q(*ops))
             for k, (sc, _) in trees.items()},
            lambda Hb=Hb, A=A, Jb=Jb: torch.baddbmm(Hb, A, Jb),
            "fused_q_dmma_kernel" if dtype == torch.float64
            else "fused_q_lower_kernel", "aten::baddbmm"))
        for Bk, nk in ((B, n),) + SCEN_CHOL_SHAPES:
            Q = _spd(rng, Bk, nk, dtype, dev)
            cases.append((
                f"K2 {dname} B={Bk} n={nk}",
                {k: (lambda ch=ch, Q=Q: ch.pallas_chol(Q))
                 for k, (_, ch) in trees.items()},
                lambda Q=Q: torch.linalg.cholesky_ex(Q), "chol_kernel",
                "aten::linalg_cholesky_ex"))
    return cases


def launch_path(dev):
    """K1's and K2's launch path at the main path's shapes: the wall time
    a call of each wrapper and of its library call, in turns
    (`host_call_ms`), beside the kernel's device time (torch.profiler).
    Returns {case: {"host_ms", "library_host_ms", "device_ms"}}."""
    from onephase_tpu_torch.ops import cholesky as ch
    from onephase_tpu_torch.ops import schur
    out = {}
    for case, fns, lib, kname, lib_op in launch_path_cases(
            dev, {"": (schur, ch)}):
        host, lib_host = host_call_ms(fns[""], lib)
        dev_ms, lib_dev = _device_ms(fns[""], kname), _device_ms(lib, lib_op)
        out[case] = {"host_ms": host, "library_host_ms": lib_host,
                     "device_ms": dev_ms, "library_device_ms": lib_dev}
        print(f"launch path {case}: {host:.4f} ms a call (device "
              f"{dev_ms:.4f}), library {lib_host:.4f} ms a call (device "
              f"{lib_dev:.4f}; {host / lib_host:.2f}x; {LAUNCH_CALLS} calls "
              "back to back, in turns)", flush=True)
    return out


def kernel_parity(dev):
    """K1-K4 against their plain versions, f32 and f64, at the main path's
    shapes, a ragged n, m = 0, n = 2048 and a non-PD Q.  Returns, per
    kernel, its record (max abs error, kernel, plain and library ms, bound)
    at the largest main-path shape in float32, with its times at
    n=256/B=16 beside them (`*_n256`; K1 also at n=2048/B=16, `*_n2048`)."""
    import torch
    from onephase_tpu_torch.ops import cholesky as ch
    from onephase_tpu_torch.ops import schur

    rng = np.random.default_rng(0)
    record, small = {}, {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        tol = TOL[dname]
        # --- K1 fused_q: (n, m, B, shared Jc/H)
        for n, m, B, shared in ((256, 128, 16, True), (1024, 512, 64, True),
                                (2048, 1024, 16, True), (130, 70, 3, False),
                                (64, 0, 2, True)):
            jshape = (m, n) if shared else (B, m, n)
            Jc = torch.as_tensor(rng.normal(size=jshape) / np.sqrt(n),
                                 dtype=dtype, device=dev)
            w = torch.as_tensor(rng.uniform(0.1, 10.0, size=(B, m)),
                                dtype=dtype, device=dev)
            H = _spd(rng, 1, n, dtype, dev)[0] if shared else \
                _spd(rng, B, n, dtype, dev)
            bnd = torch.as_tensor(rng.uniform(0.0, 5.0, size=(B, n)),
                                  dtype=dtype, device=dev)
            got = schur.pallas_fused_q(Jc, w, H, bnd)
            ref = schur.xla_fused_q(Jc, w, H, bnd)
            torch.cuda.synchronize()
            e, ea = _err(got, ref)
            line = f"K1 fused_q {dname} n={n} m={m} B={B}: err {e:.3e}"
            if n in (256, 1024, 2048):
                Hb, A, Jb = _baddbmm_operands(Jc, w, H, B)
                ms, pms, lms = _time_turns(
                    lambda: schur.pallas_fused_q(Jc, w, H, bnd),
                    lambda: schur.xla_fused_q(Jc, w, H, bnd),
                    lambda: torch.baddbmm(Hb, A, Jb))
                bd1 = _fused_q_bound(B, m, n, Jc.element_size())
                tflops = B * m * n * (n + 1) / (ms * 1e-3) / 1e12
                line += (f" kernel {ms:.4f} ms ({tflops:.2f} TFLOP/s of the "
                         f"symmetric work) plain {pms:.4f} ms baddbmm "
                         f"{lms:.4f} ms (in turns; {ms / pms:.2f}x plain, "
                         f"{ms / lms:.2f}x baddbmm) bound {bd1[0]:.4f} ms")
                if dtype == torch.float32 and n == 256:
                    small["fused_q"] = dict(
                        ms_n256=ms, plain_ms_n256=pms, library_ms_n256=lms,
                        bound_ms_n256=bd1[0])
                if n == 1024 and dtype == torch.float32:
                    record["fused_q"] = dict(
                        max_abs_err=ea, ms=ms, plain_ms=pms, library_ms=lms,
                        **_kv(bd1), **small["fused_q"])
                if n == 1024 and dtype == torch.float64:
                    record["fused_q"].update(_f64_keys(ms, pms, lms, bd1))
                if n == 2048 and dtype == torch.float32:
                    record["fused_q"].update(
                        ms_n2048=ms, plain_ms_n2048=pms, library_ms_n2048=lms,
                        bound_ms_n2048=bd1[0])
            print(line, flush=True)
            if not e <= tol:
                raise RuntimeError(f"K1 disagrees: {line}")
        # zero-Hessian (LP) form: H = None
        got = schur.pallas_fused_q(Jc, w, None, bnd)
        e, _ = _err(got, schur.xla_fused_q(Jc, w, None, bnd))
        if not e <= tol:
            raise RuntimeError(f"K1 with H=None disagrees: {e}")

        # --- K2 chol, K3 tri_inv_gram, K4 chol_inv
        for n, B in ((256, 16), (1024, 64), (130, 3), (2048, 2)):
            Q = _spd(rng, B, n, dtype, dev)
            L, d, ok = ch.pallas_chol(Q)
            Lr, dr, okr = ch.xla_chol(Q)
            torch.cuda.synchronize()
            if not bool(ok.all()) or not bool(okr.all()):
                raise RuntimeError(f"K2 rejected an SPD matrix (n={n})")
            (e2, e2a), (e2d, _) = _err(L, Lr), _err(d, dr)
            e2 = max(e2, e2d)
            M = ch.pallas_tri_inv_gram(L)
            Mr = ch.xla_chol_inv_from_L(Lr)
            torch.cuda.synchronize()
            e3, e3a = _err(M, Mr)
            if not torch.equal(M, M.mT):
                raise RuntimeError(f"K3's M is not symmetric (n={n})")
            M4, d4, ok4 = ch.pallas_chol_inv(Q)
            torch.cuda.synchronize()
            e4 = max(_err(M4, M)[0], _err(d4, d)[0])
            line = (f"K2 chol {dname} n={n} B={B}: err {e2:.3e} | "
                    f"K3 tri_inv_gram err {e3:.3e} | K4 chol_inv err {e4:.3e}")
            if n in (256, 1024):
                # K2 and its yardstick, cuSOLVER's batched Cholesky (never
                # called by the port), in turns
                t2, l2, p2 = _time_turns(lambda: ch.pallas_chol(Q),
                                         lambda: torch.linalg.cholesky_ex(Q),
                                         lambda: ch.xla_chol(Q))
                # K3, its plain version and its yardstick cholesky_inverse
                # (M = (L L^T)^-1 from L), with K3's two launches apart
                Li, Mg = torch.empty_like(L), torch.empty_like(L)
                t3, p3, l3, ti3, tg3 = _time_turns(
                    lambda: ch.pallas_tri_inv_gram(L),
                    lambda: ch.xla_chol_inv_from_L(Lr),
                    lambda: torch.cholesky_inverse(Lr),
                    lambda: ch.launch_tri_inv(L, Li),
                    lambda: schur.launch_fused_q(Li, None, None, None, Mg,
                                                 lower=True))
                el = Q.element_size()
                # K2 reads Q, writes L, d, ok: B n^3 / 3 operations
                bd2 = _bound(el * (2 * B * n * n + B * n) + 4 * B,
                             B * n ** 3 / 3, dname)
                # K3 reads L, writes M: L^-1 (B n^3 / 3) and the Gram
                # product (B n^3 / 3); each half alone reads one (B, n, n)
                # and writes one
                bd3 = _bound(el * 2 * B * n * n, 2 * B * n ** 3 / 3, dname)
                bdh = _bound(el * 2 * B * n * n, B * n ** 3 / 3, dname)

                def tf(flops, ms):
                    return flops / (ms * 1e-3) / 1e12

                f3 = B * n ** 3 / 3
                line += (f" | chol {t2:.4f} ms ({tf(f3, t2):.2f} TFLOP/s; "
                         f"bound {bd2[0]:.4f} ms = "
                         f"{PEAK_FLOPS[dname] / 1e12:.0f} TFLOP/s) "
                         f"cholesky_ex {l2:.4f} ms ({t2 / l2:.2f}x) plain "
                         f"{p2:.4f} ms | tri_inv_gram {t3:.4f} ms "
                         f"({tf(2 * f3, t3):.2f} TFLOP/s; bound "
                         f"{bd3[0]:.4f} ms) plain {p3:.4f} ms "
                         f"({t3 / p3:.2f}x) cholesky_inverse {l3:.4f} ms "
                         f"({t3 / l3:.2f}x); its launches: tri_inv "
                         f"{ti3:.4f} ms ({tf(f3, ti3):.2f} TFLOP/s) gram "
                         f"{tg3:.4f} ms ({tf(f3, tg3):.2f} TFLOP/s), bound "
                         f"{bdh[0]:.4f} ms each (in turns)")
                if dtype == torch.float32 and n == 256:
                    small["chol"] = dict(ms_n256=t2, plain_ms_n256=p2,
                                         library_ms_n256=l2,
                                         bound_ms_n256=bd2[0])
                    small["tri_inv_gram"] = dict(
                        ms_n256=t3, plain_ms_n256=p3, library_ms_n256=l3,
                        bound_ms_n256=bd3[0], tri_inv_ms_n256=ti3,
                        gram_ms_n256=tg3)
                if n == 1024 and dtype == torch.float32:
                    record["chol"] = dict(
                        max_abs_err=e2a, ms=t2, plain_ms=p2, library_ms=l2,
                        **_kv(bd2), **small["chol"])
                    record["tri_inv_gram"] = dict(
                        max_abs_err=e3a, ms=t3, plain_ms=p3, library_ms=l3,
                        **_kv(bd3), tri_inv_ms=ti3, gram_ms=tg3,
                        **small["tri_inv_gram"])
                if n == 1024 and dtype == torch.float64:
                    record["chol"].update(_f64_keys(t2, p2, l2, bd2))
                    record["tri_inv_gram"].update(_f64_keys(t3, p3, l3, bd3))
            print(line, flush=True)
            if not (e2 <= tol and e3 <= tol and e4 <= tol):
                raise RuntimeError(f"K2/K3/K4 disagree: {line}")
        # non-PD input: ok must be 0
        Q = _spd(rng, 4, 130, dtype, dev)
        Q = Q - 1e3 * 130 * torch.eye(130, dtype=dtype, device=dev)
        _, _, ok = ch.pallas_chol(Q)
        _, _, okr = ch.xla_chol(Q)
        torch.cuda.synchronize()
        if bool(ok.any()) or bool(okr.any()):
            raise RuntimeError("K2 accepted a non-PD matrix")
        print(f"K2 chol {dname} non-PD n=130 B=4: ok = 0 for every instance",
              flush=True)
    return record


def fused_q_per_instance(dev):
    """K1 with a (B, m, n) Jacobian, each instance its own A, and no H (a
    declared-zero Hessian): the campaign path's call at its full width
    (B = 64, m = 512, n = 1024, float32), held to its plain version and
    timed in turns with it and `torch.baddbmm`.  The inputs are scaled as
    the kernel phase's (Jc / sqrt(n), w in [0.1, 10]), so that diag(bnd)
    is a fifth or more of max |Q|, and the diagonal is also held on its
    own: a kernel that drops bnd, or reads one instance's for all, fails.
    The bound reads the whole (B, m, n) Jc."""
    import torch
    from onephase_tpu_torch.ops import schur

    B, m, n = 2 * CAMP_C1["n_pairs"], CAMP_C1["m"], CAMP_C1["n"]
    rng = np.random.default_rng(13)
    A = rng.normal(size=(B, m, n)) / np.sqrt(n) * \
        (rng.random((B, m, n)) < 0.5)
    Jc = torch.as_tensor(A, dtype=torch.float32, device=dev)
    w = torch.as_tensor(rng.uniform(0.1, 10.0, size=(B, m)),
                        dtype=torch.float32, device=dev)
    bnd = torch.as_tensor(rng.uniform(0.0, 5.0, size=(B, n)),
                          dtype=torch.float32, device=dev)
    got = schur.pallas_fused_q(Jc, w, None, bnd)
    ref = schur.xla_fused_q(Jc, w, None, bnd)
    torch.cuda.synchronize()
    e, ea = _err(got, ref)
    ed, _ = _err(got.diagonal(dim1=1, dim2=2), ref.diagonal(dim1=1, dim2=2))
    Hb, Aw, Jb = _baddbmm_operands(Jc, w, None, B)
    ms, pms, lms = _time_turns(
        lambda: schur.pallas_fused_q(Jc, w, None, bnd),
        lambda: schur.xla_fused_q(Jc, w, None, bnd),
        lambda: torch.baddbmm(Hb, Aw, Jb))
    bd = _bound(4 * (B * m * n + B * m + B * n + B * n * n),
                B * m * n * (n + 1))
    print(f"K1 fused_q float32 per-instance Jc (B={B}, m={m}, n={n}, H=None):"
          f" err {e:.3e} kernel {ms:.4f} ms "
          f"({B * m * n * (n + 1) / (ms * 1e-3) / 1e12:.2f} TFLOP/s of the "
          f"symmetric work) plain {pms:.4f} ms baddbmm {lms:.4f} ms (in "
          f"turns; {ms / pms:.2f}x plain, {ms / lms:.2f}x baddbmm) bound "
          f"{bd[0]:.4f} ms ({bd[1]}); diagonal err {ed:.3e}", flush=True)
    if not (e <= TOL["float32"] and ed <= TOL["float32"]):
        raise RuntimeError(f"K1 with a per-instance Jc disagrees: {e}, "
                           f"diagonal {ed}")
    return {"max_abs_err": ea, "ms": ms, "plain_ms": pms, "library_ms": lms,
            **_kv(bd), "shape": [B, m, n]}


def chain_pattern(K, nx):
    """The structural pattern of H + J'J of chain_ocp(K, nx, .) as a flat
    NLP: block tridiagonal with dense (nx, nx) blocks; (n, n) bool."""
    blk = np.arange(K)
    tri = np.abs(blk[:, None] - blk[None, :]) <= 1
    return tri.repeat(nx, axis=0).repeat(nx, axis=1)


def fused_q_tri_parity(dev):
    """K6 against its plain version and against K1, f32 and f64: the dense
    path's two shapes, a ragged n, one tile, m = 0, H = None, shared
    (stride-0) and per-instance Jc and H, an unsymmetric H.  With a
    bit-symmetric H (or none) Q must equal its transpose bit for bit; K6's
    full Q must equal K1's bit for bit (one kernel), and so its lower
    triangle.  Returns K6's record at n=1024, m=512, B=64 in float32, with
    the launches of this phase (K6 is on no path)."""
    import torch
    from onephase_tpu_torch import ops
    from onephase_tpu_torch.ops import schur

    rng = np.random.default_rng(6)
    before = ops.launch_counts()["fused_q_tri"]
    record = None
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        tol = TOL[dname]
        # (n, m, B, shared Jc/H, with H)
        for n, m, B, shared, with_h in (
                (1024, 512, 64, True, True), (256, 128, 16, True, True),
                (130, 70, 3, False, True), (40, 30, 2, False, True),
                (64, 0, 2, True, True), (200, 300, 2, True, False)):
            jshape = (m, n) if shared else (B, m, n)
            Jc = torch.as_tensor(rng.normal(size=jshape) / np.sqrt(n),
                                 dtype=dtype, device=dev)
            w = torch.as_tensor(rng.uniform(0.1, 10.0, size=(B, m)),
                                dtype=dtype, device=dev)
            bnd = torch.as_tensor(rng.uniform(0.0, 5.0, size=(B, n)),
                                  dtype=dtype, device=dev)
            H = None
            if with_h:
                H = _spd(rng, 1, n, dtype, dev)[0] if shared else \
                    _spd(rng, B, n, dtype, dev)
                H = (0.5 * (H + H.transpose(-1, -2))).contiguous()
            got = schur.pallas_fused_q_tri(Jc, w, H, bnd)
            ref = schur.xla_fused_q(Jc, w, H, bnd)
            k1 = schur.pallas_fused_q(Jc, w, H, bnd)
            torch.cuda.synchronize()
            (e, ea), (e1, _) = _err(got, ref), _err(got, k1)
            sym = torch.equal(got, got.transpose(-1, -2))
            tril_k1 = torch.equal(torch.tril(got), torch.tril(k1))
            full_k1 = torch.equal(got, k1)
            line = (f"K6 fused_q_tri {dname} n={n} m={m} B={B} "
                    f"{'shared' if shared else 'batched'} "
                    f"{'H' if with_h else 'H=None'}: err {e:.3e} vs K1 "
                    f"{e1:.3e} symmetric {sym} lower triangle equal to K1's "
                    f"{tril_k1} full Q equal to K1's {full_k1}")
            if with_h:
                # an unsymmetric H is added where it stands
                Hu = H + torch.as_tensor(rng.normal(size=tuple(H.shape)),
                                         dtype=dtype, device=dev)
                qu = schur.pallas_fused_q_tri(Jc, w, Hu, bnd)
                eu, _ = _err(qu, schur.xla_fused_q(Jc, w, Hu, bnd))
                k1u = schur.pallas_fused_q(Jc, w, Hu, bnd)
                tril_k1 &= torch.equal(torch.tril(qu), torch.tril(k1u))
                full_k1 &= torch.equal(qu, k1u)
                line += (f" unsymmetric-H err {eu:.3e} lower triangle equal "
                         f"to K1's {tril_k1} full Q equal to K1's {full_k1}")
                e = max(e, eu)
            if n in (256, 1024):
                Hb, A, Jb = _baddbmm_operands(Jc, w, H, B)
                ms, k1ms, pms, lms = _time_turns(
                    lambda: schur.pallas_fused_q_tri(Jc, w, H, bnd),
                    lambda: schur.pallas_fused_q(Jc, w, H, bnd),
                    lambda: schur.xla_fused_q(Jc, w, H, bnd),
                    lambda: torch.baddbmm(Hb, A, Jb))
                line += (f" kernel {ms:.4f} ms K1 {k1ms:.4f} ms plain "
                         f"{pms:.4f} ms baddbmm {lms:.4f} ms (in turns)")
                if n == 1024 and dtype == torch.float32:
                    record = dict(
                        max_abs_err=ea, ms=ms, plain_ms=pms, library_ms=lms,
                        **_kv(_fused_q_bound(B, m, n, Jc.element_size())))
                if n == 1024 and dtype == torch.float64:
                    record.update(_f64_keys(
                        ms, pms, lms,
                        _fused_q_bound(B, m, n, Jc.element_size())))
                if n == 256 and dtype == torch.float32:
                    record.update(
                        ms_n256=ms, plain_ms_n256=pms, library_ms_n256=lms,
                        bound_ms_n256=_fused_q_bound(B, m, n, 4)[0])
            print(line, flush=True)
            if not (e <= tol and e1 <= tol and sym and tril_k1 and full_k1):
                raise RuntimeError(f"K6 disagrees: {line}")
    record["launches"] = ops.launch_counts()["fused_q_tri"] - before
    return record


def _kv(bound):
    return {"bound_ms": bound[0], "bound_by": bound[1]}


def _f64_keys(ms, plain_ms, library_ms, bound):
    """A float32 record's float64 figures at the same shape (`*_f64`)."""
    return {"ms_f64": ms, "plain_ms_f64": plain_ms,
            "library_ms_f64": library_ms, "bound_ms_f64": bound[0],
            "bound_by_f64": bound[1]}


def _band(rng, B, K, nb, dtype, device):
    """Block-tridiagonal SPD band from the seeded numpy generator:
    A_k = G G^T + 3 I, B_k = 0.3 N(0, 1) (formed in float64)."""
    import torch
    G = rng.normal(size=(B, K, nb, nb))
    Ad = G @ G.transpose(0, 1, 3, 2) + 3.0 * np.eye(nb)
    Bs = rng.normal(size=(B, max(K - 1, 0), nb, nb)) * 0.3
    return (torch.as_tensor(Ad, dtype=dtype, device=device),
            torch.as_tensor(Bs, dtype=dtype, device=device))


def _tridiag_dep_bounds(K, nb, hz):
    """(K7's, K5's) dependence bounds in ms at one shape and SM clock `hz`:
    the dependent FMA latencies a run cannot overlap.  K5: 2K stages, each
    two chains of nb FMAs (E v, then Ci r).  K7: K stages, each four chains
    of nb (the E E^T dot product, the Cholesky's and the inverse's column
    recurrences, the E_k dot product), counted as one FMA a step though
    each Cholesky step also waits on a square root and a division."""
    per = FMA_LATENCY_CYCLES / hz * 1e3
    return K * 4 * nb * per, 2 * K * 2 * nb * per


def _tridiag_work(B, K, nb, el):
    """((K7's bytes, operations), (K5's bytes, operations)) at one shape,
    element size `el`."""
    blk = nb * nb
    # K7 reads Ad, Bs, delta, writes Ck, Ci, Ek, ok; per stage E E^T and
    # E_k = B_k Ci^T on nb (nb + 1) / 2 entries of length nb (k >= 1,
    # k < K-1), Cholesky and triangular inverse nb^3 / 3 each
    f7 = B * ((K - 1) * 2 * 2 * blk * (nb + 1) / 2 + K * 2 * nb ** 3 / 3)
    b7 = el * B * (3 * K * blk + 2 * (K - 1) * blk + 1) + 4 * B
    # K5 reads Ci, Ek, b, writes x; two nb x nb matvecs a stage in each
    # sweep (one at the chain's ends)
    f5 = B * 2 * 2 * blk * (2 * K - 1)
    b5 = el * B * (K * blk + (K - 1) * blk + 2 * K * nb)
    return (b7, f7), (b5, f5)


def _tridiag_bounds(B, K, nb, el):
    """(K7's bound, K5's bound) at one shape, element size `el`."""
    return tuple(_bound(nbytes, flops, DNAME[el])
                 for nbytes, flops in _tridiag_work(B, K, nb, el))


def tridiag_parity(dev):
    """K7 (tridiag_factor) and K5 (tridiag_solve) against their plain
    versions, f32 and f64: at the chain path's shape (B=1, K=400, nb=32),
    the banded path's (K=204, nb=63 and K=200, nb=64), a ragged nb=30 with
    K=7, K=1, and a non-PD band (ok False from both).  Returns, per kernel,
    its record at the chain path's shape in float32, with its times at the
    banded path's shape beside it (`*_banded`)."""
    import torch
    from onephase_tpu_torch.ops import tridiag_pallas as tp

    rng = np.random.default_rng(2)
    record = {}
    hz = _sm_max_hz()
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        tol = TOL[dname]
        band = (BANDED_BAND["K"], BANDED_BAND["nb"])
        for B, K, nb in ((1, 400, 32), (1,) + band, (1, 200, 64), (2, 7, 30),
                         (2, 1, 32)):
            Ad, Bs = _band(rng, B, K, nb, dtype, dev)
            delta = torch.full((B,), 1e-4, dtype=dtype, device=dev)
            Ck, Ci, Ek, ok = tp.pallas_tridiag_factor(Ad, Bs, delta)
            Ckr, Cir, Ekr, okr = tp.xla_tridiag_factor_inv(Ad, Bs, delta)
            b = torch.as_tensor(rng.normal(size=(B, K, nb)), dtype=dtype,
                                device=dev)
            x = tp.pallas_tridiag_solve(Ci, Ek, b)
            xr = tp.xla_tridiag_solve_inv(Cir, Ekr, b)
            torch.cuda.synchronize()
            if not (bool(ok.all()) and bool(okr.all())):
                raise RuntimeError(f"K7 rejected an SPD band (K={K})")
            errs = [_err(Ck, Ckr), _err(Ci, Cir)]
            if K > 1:
                errs.append(_err(Ek, Ekr))
            e7, e7a = max(e for e, _ in errs), max(a for _, a in errs)
            e5, e5a = _err(x, xr)
            line = (f"K7 tridiag_factor {dname} B={B} K={K} nb={nb}: err "
                    f"{e7:.3e} | K5 tridiag_solve err {e5:.3e}")
            if (K, nb) in ((CHAIN_SHAPE["K"], CHAIN_SHAPE["nx"]), band):
                t7, p7 = _time_turns(
                    lambda: tp.pallas_tridiag_factor(Ad, Bs, delta),
                    lambda: tp.xla_tridiag_factor_inv(Ad, Bs, delta))
                t5 = _time_ms(lambda: tp.pallas_tridiag_solve(Ci, Ek, b))
                p5 = _time_ms(lambda: tp.xla_tridiag_solve_inv(Ci, Ek, b))
                d5 = _device_ms(lambda: tp.pallas_tridiag_solve(Ci, Ek, b),
                                "tridiag_solve_kernel")
                bd7, bd5 = _tridiag_bounds(B, K, nb, Ad.element_size())
                dep7, dep5 = _tridiag_dep_bounds(K, nb, hz)
                line += (f" | factor {t7:.4f} ms ({1e3 * t7 / K:.2f} us a "
                         f"stage) plain {p7:.4f} ms bound {bd7[0]:.4f} ms "
                         f"({bd7[1]}), dependence bound {dep7:.4f} ms | "
                         f"solve {t5:.4f} ms (device {d5:.4f} ms, "
                         f"{1e3 * d5 / (2 * K):.3f} us a stage) plain "
                         f"{p5:.4f} ms bound {bd5[0]:.4f} ms ({bd5[1]}), "
                         f"dependence bound {dep5:.4f} ms at "
                         f"{hz / 1e6:.0f} MHz"
                         " | no library call computes either")
                if dtype == torch.float32 and nb == CHAIN_SHAPE["nx"]:
                    record["tridiag_factor"] = dict(
                        max_abs_err=e7a, ms=t7, plain_ms=p7, library_ms=None,
                        **_kv(bd7), dep_bound_ms=dep7)
                    record["tridiag_solve"] = dict(
                        max_abs_err=e5a, ms=t5, plain_ms=p5, library_ms=None,
                        **_kv(bd5), device_ms=d5, dep_bound_ms=dep5)
                elif dtype == torch.float32:
                    record["tridiag_factor"].update(
                        ms_banded=t7, plain_ms_banded=p7,
                        bound_ms_banded=bd7[0], dep_bound_ms_banded=dep7)
                    record["tridiag_solve"].update(
                        ms_banded=t5, plain_ms_banded=p5,
                        bound_ms_banded=bd5[0], device_ms_banded=d5,
                        dep_bound_ms_banded=dep5)
                else:   # float64, no library call either
                    key = "_f64" if nb == CHAIN_SHAPE["nx"] else \
                        "_f64_banded"
                    for name, t, pl, bd in (("tridiag_factor", t7, p7, bd7),
                                            ("tridiag_solve", t5, p5, bd5)):
                        record[name].update({
                            f"ms{key}": t, f"plain_ms{key}": pl,
                            f"library_ms{key}": None,
                            f"bound_ms{key}": bd[0],
                            f"bound_by{key}": bd[1]})
            print(line, flush=True)
            if not (e7 <= tol and e5 <= tol):
                raise RuntimeError(f"K5/K7 disagree: {line}")
        # non-PD band: ok must be False from both, for that instance only
        Ad, Bs = _band(rng, 3, 8, 30, dtype, dev)
        Ad[1, 3] -= 50.0 * torch.eye(30, dtype=dtype, device=dev)
        ok = tp.pallas_tridiag_factor(Ad, Bs, 0.0)[3]
        okr = tp.xla_tridiag_factor_inv(Ad, Bs, 0.0)[3]
        if not ok.tolist() == okr.tolist() == [True, False, True]:
            raise RuntimeError(f"K7 inertia flag {ok.tolist()} vs plain "
                               f"{okr.tolist()} on a non-PD band")
        print(f"K7 tridiag_factor {dname} non-PD band: ok = "
              f"{ok.tolist()} from both", flush=True)
    return record


def chain_run(dev, lane, precision_name=None):
    """scripts/bench_large.py:54-67 on the port: chain_ocp(K=400, nx=32,
    mc=16) in float32 through ChainKernel on `lane`; one warm-up chunk,
    then a timed run from a fresh state to termination.  Launches are
    counted from the fresh state's init on.  With `precision_name`, under
    that `matmul_precision`: the run ends with any final status, and on
    `pallas` K5 and K7 must launch in its mode only.  Returns (summary,
    final x)."""
    import torch
    from onephase_tpu_torch import ops
    from onephase_tpu_torch.config import Params
    from onephase_tpu_torch.ipm.state import RUNNING, STATUS_NAMES
    from onephase_tpu_torch.models.examples import chain_ocp
    from onephase_tpu_torch.ops import precision
    from onephase_tpu_torch.parallel.chain import ChainKernel

    extra = {"kkt.linear_solver_type": lane}
    if precision_name is not None:
        extra["matmul_precision"] = precision_name
    pars = Params().with_overrides(dict(CHAIN_OPTIONS, **extra))
    spec = chain_ocp(**CHAIN_SHAPE, device=dev)
    ck = ChainKernel(spec, pars, dtype=torch.float32, device=dev)
    ck.run_chunk(ck.initial_state())
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    st = ck.initial_state()
    torch.cuda.synchronize()
    ck.host_syncs = 0
    t0 = time.perf_counter()
    while int(st.status[0]) == RUNNING:
        st = ck.run_chunk(st)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    mode = str(precision.resolve(pars.matmul_precision, "cuda"))
    summary = {
        "lane": lane, "precision": pars.matmul_precision, "mode": mode,
        "status": STATUS_NAMES[int(st.status[0])],
        "outer_its": int(st.t[0]) - 1, "cum_fac": int(st.cum_fac[0]),
        "obj": float(st.cache.fval[0]), "seconds": dt,
        "host_syncs": ck.host_syncs, "launches": ops.launch_counts(),
        "launch_modes": ops.launch_modes()}
    label = lane if precision_name is None else \
        f"{lane} {precision_name} ({mode})"
    print(f"chain K={CHAIN_SHAPE['K']} nx={CHAIN_SHAPE['nx']} "
          f"mc={CHAIN_SHAPE['mc']} f32 {label}: {summary['status']} obj "
          f"{summary['obj']:.6f} in {summary['outer_its']} outer its, "
          f"{summary['cum_fac']} factorizations, {dt:.4f} s, host_syncs "
          f"{ck.host_syncs}, launches {summary['launches']}, by mode "
          f"{json.dumps(summary['launch_modes'])}", flush=True)
    if precision_name is None and summary["status"] != "Optimal":
        raise RuntimeError(f"chain {lane}: {summary['status']}")
    if summary["status"] == STATUS_NAMES[RUNNING]:
        raise RuntimeError(f"chain {label}: still running")
    if lane == "pallas":
        for k in ("tridiag_factor", "tridiag_solve"):
            n = summary["launches"][k]
            if not (n > 0 and summary["launch_modes"].get(k) == {mode: n}):
                raise RuntimeError(f"chain {label}: {k} not launched in "
                                   f"{mode} only: {summary['launch_modes']}")
    return summary, st.p.x[0]


def banded_kernel(dev, shape, lane, matrix_free, pattern=None):
    """chain_ocp(**shape) lowered to a flat NLP, in float32 through
    BandedKernel on `lane` with CHAIN_OPTIONS; `pattern` None detects the
    structure from dense samples.  Prints the host-side analysis (seconds
    of the constructor: pattern, RCM, probes; bandwidth and block layout)
    and returns the kernel."""
    import torch
    from onephase_tpu_torch import native
    from onephase_tpu_torch.config import Params
    from onephase_tpu_torch.models.examples import chain_ocp
    from onephase_tpu_torch.nlp import canonicalize
    from onephase_tpu_torch.parallel.banded import BandedKernel

    pars = Params().with_overrides(
        dict(CHAIN_OPTIONS, **{"kkt.linear_solver_type": lane}))
    nlp = canonicalize(chain_ocp(**shape, device=dev).to_nlpspec(),
                       dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    bk = BandedKernel(nlp, pars, matrix_free=matrix_free, pattern=pattern,
                      device=dev)
    torch.cuda.synchronize()
    print(f"banded K={shape['K']} nx={shape['nx']} mc={shape['mc']} "
          f"{'matrix-free' if matrix_free else 'assembled'} {lane}: "
          f"constructor (pattern "
          f"{'given' if pattern is not None else 'sampled'}, RCM on the "
          f"{native.route()} route, probes) "
          f"{time.perf_counter() - t0:.3f} s; n={nlp.n} bandwidth "
          f"{bk.bandwidth} nb={bk.nb} K={bk.K} n_pad={bk.n_pad}", flush=True)
    return bk


def banded_run(dev, shape, lane, matrix_free, pattern=None):
    """One warm-up chunk, then a timed run from a fresh state to
    termination, as chain_run.  Returns (summary, final x)."""
    import torch
    from onephase_tpu_torch import ops
    from onephase_tpu_torch.ipm.state import RUNNING, STATUS_NAMES

    bk = banded_kernel(dev, shape, lane, matrix_free, pattern)
    bk.run_chunk(bk.initial_state())
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    st = bk.initial_state()
    torch.cuda.synchronize()
    bk.host_syncs = 0
    t0 = time.perf_counter()
    while int(st.status[0]) == RUNNING:
        st = bk.run_chunk(st)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    mode = "matrix-free" if matrix_free else "assembled"
    summary = {
        "lane": lane, "mode": mode, "band": {"K": bk.K, "nb": bk.nb},
        "status": STATUS_NAMES[int(st.status[0])],
        "outer_its": int(st.t[0]) - 1, "cum_fac": int(st.cum_fac[0]),
        "obj": float(st.cache.fval[0]), "seconds": dt,
        "host_syncs": bk.host_syncs, "launches": ops.launch_counts(),
        "peak_mb": torch.cuda.max_memory_allocated() / 2 ** 20}
    print(f"banded K={shape['K']} nx={shape['nx']} mc={shape['mc']} f32 "
          f"{mode} {lane}: {summary['status']} obj {summary['obj']:.6f} in "
          f"{summary['outer_its']} outer its, {summary['cum_fac']} "
          f"factorizations, {dt:.4f} s, host_syncs {bk.host_syncs}, peak "
          f"device memory {summary['peak_mb']:.1f} MiB, launches "
          f"{summary['launches']}", flush=True)
    if summary["status"] != "Optimal":
        raise RuntimeError(f"banded {mode} {lane}: {summary['status']}")
    return summary, st.p.x[0]


def _rel_diff(x, ref):
    return float((x - ref).abs().max() / ref.abs().max())


def banded_phase(dev, chain, x_chain):
    """The banded path: full width, matrix-free, `pallas` lane, held to the
    chain run's argmin; then the reduced shape, assembled against
    matrix-free and `pallas` against `xla`.  Returns the full-width
    summary."""
    full, x_full = banded_run(dev, CHAIN_SHAPE, "pallas", True,
                              chain_pattern(CHAIN_SHAPE["K"],
                                            CHAIN_SHAPE["nx"]))
    if full["band"] != BANDED_BAND:
        raise RuntimeError(f"the band is {full['band']}, the kernel phase "
                           f"timed {BANDED_BAND}")
    xdiff = _rel_diff(x_full, x_chain)
    print(f"banded argmin vs the chain path's: max rel diff {xdiff:.3e}; "
          f"outer its {full['outer_its']} vs {chain['outer_its']}, obj "
          f"{full['obj']:.6f} vs {chain['obj']:.6f}", flush=True)
    if not xdiff < 1e-3:
        raise RuntimeError("the banded and chain argmins disagree")
    for k in ("tridiag_factor", "tridiag_solve"):
        if full["launches"][k] <= 0:
            raise RuntimeError(f"kernel {k} was not launched by the banded "
                               "path")

    small = BANDED_SMALL_SHAPE
    mf, x_mf = banded_run(dev, small, "pallas", True)
    asm, x_asm = banded_run(dev, small, "pallas", False)
    xla, x_xla = banded_run(dev, small, "xla", False)
    d_mode, d_lane = _rel_diff(x_mf, x_asm), _rel_diff(x_asm, x_xla)
    print(f"banded K={small['K']} argmin: matrix-free vs assembled max rel "
          f"diff {d_mode:.3e}, pallas vs xla {d_lane:.3e}; outer its "
          f"{mf['outer_its']} / {asm['outer_its']} / {xla['outer_its']}",
          flush=True)
    if not (d_mode < 1e-3 and d_lane < 1e-3):
        raise RuntimeError("the banded modes' or lanes' argmins disagree")
    if not mf["outer_its"] == asm["outer_its"] == xla["outer_its"]:
        raise RuntimeError("the banded modes or lanes took different "
                           "numbers of outer iterations")
    return full


def hs071(dev):
    import torch
    import onephase_tpu_torch as opt
    from onephase_tpu_torch.models import zoo
    nlp = opt.canonicalize(zoo.hs071(), dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    r = opt.one_phase_solve(nlp, options={
        "output_level": 0, "term!max_it": 200,
        "kkt.linear_solver_type": "pallas"})
    dt = time.perf_counter() - t0
    print(f"HS071 f64 pallas: {r.status} obj {r.obj:.10f} in {r.iterations} "
          f"iterations, {dt:.3f} s, host_syncs {r.kernel.host_syncs}",
          flush=True)
    if r.status != "Optimal" or abs(r.obj - 17.0140173) > 1e-6:
        raise RuntimeError(f"HS071: {r.status} obj {r.obj}")


def bench_run(dev, n, m, batch, lane, extra=None, warmup=True,
              require_all=True, base=None, dtype="float32", seed=0):
    """bench.py:141-163 on the port: a warm-up chunk, then a timed run of
    fresh states to completion, with the batch driver's float64
    termination recheck between chunks.  `base` replaces the bench
    options, `dtype` the solve dtype; `seed` draws the QP (make_qp's
    seed) and seed + 1 the starts (bench.py's 0 and 1).  Returns
    (summary, final state, kernel)."""
    import torch
    from onephase_tpu_torch import ops
    from onephase_tpu_torch.config import Params
    from onephase_tpu_torch.ipm.state import OPTIMAL, RUNNING
    from onephase_tpu_torch.models.qp import make_qp
    from onephase_tpu_torch.nlp import canonicalize
    from onephase_tpu_torch.parallel.batch import BatchSolver

    options = dict(base or BENCH_OPTIONS, **(extra or {}))
    options["kkt.linear_solver_type"] = lane
    pars = Params().with_overrides(options)
    nlp = canonicalize(make_qp(n, m, seed=seed, device=dev),
                       dtype=getattr(torch, dtype), device=dev)
    solver = BatchSolver(nlp, pars)
    x0s = np.random.default_rng(seed + 1).normal(size=(batch, nlp.n)) * 0.1
    if warmup:
        solver.run_chunk(solver.init(x0s))
        torch.cuda.synchronize()
    max_chunks = -(-pars.term.max_it // pars.chunk_size)
    # launches are counted from the fresh state's init on; time and host
    # syncs over the chunk loop only, as bench.py times it
    ops.reset_launch_counts()
    st = solver.init(x0s)
    torch.cuda.synchronize()
    solver.kernel.host_syncs = 0
    t0 = time.perf_counter()
    for _ in range(max_chunks):
        st = solver.recheck_f64(solver.run_chunk(st))
        if not bool((st.status == RUNNING).any()):
            break
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ops.launch_counts()
    launch_modes = ops.launch_modes()
    solved = int((st.status == OPTIMAL).sum())
    fac = int(st.cum_fac.sum())
    outer = int((st.t - 1).sum())
    summary = {
        "n": n, "m": m, "batch": batch, "lane": lane,
        "solved": solved, "seconds": dt, "fac_per_s": fac / dt,
        "solves_per_s": solved / dt, "outer_its": outer, "cum_fac": fac,
        "host_syncs": solver.kernel.host_syncs, "launches": launches,
        "launch_modes": launch_modes, "statuses": solver.statuses(st)}
    print(f"bench n={n} m={m} B={batch} {dtype} {lane} {extra or ''}: "
          f"{solved}/{batch} Optimal, "
          f"{fac / dt:.2f} fac/s, {solved / dt:.2f} solves/s, {outer} outer "
          f"its, {fac} factorizations, {dt:.4f} s, host_syncs "
          f"{summary['host_syncs']}, launches {launches}", flush=True)
    if require_all and solved != batch:
        raise RuntimeError(f"bench n={n} {lane}: only {solved}/{batch} "
                           f"certified: {summary['statuses']}")
    return summary, st, solver.kernel


@contextlib.contextmanager
def _operand_dtypes():
    """The dtypes K1, K2 and K3's wrappers are called with inside the
    block: {kernel: set of dtype names}.  It wraps the functions the solver
    calls (and restores them); the launch counts stay the wrappers' own."""
    import onephase_tpu_torch.ipm.core as core
    from onephase_tpu_torch.ops import schur
    seen = {"fused_q": set(), "chol": set(), "tri_inv_gram": set()}
    saved = (schur.pallas_fused_q, core.pallas_chol, core.pallas_tri_inv_gram)

    def wrap(name, fn):
        def call(*args):
            seen[name].add(str(args[-1].dtype).split(".")[-1])
            return fn(*args)
        return call

    schur.pallas_fused_q = wrap("fused_q", saved[0])
    core.pallas_chol = wrap("chol", saved[1])
    core.pallas_tri_inv_gram = wrap("tri_inv_gram", saved[2])
    try:
        yield seen
    finally:
        (schur.pallas_fused_q, core.pallas_chol,
         core.pallas_tri_inv_gram) = saved


def mixed_kernel_times(dev):
    """K1, K2 and K3 at the mixed phase's shape (n=1024, m=512, B=16), on
    the QP's own Jc and H, in float64 and on the same operands cast to
    float32 (the factor_precision="f32" route), each pair in turns with
    the casts the route adds and each kernel's library call in both
    types (`baddbmm`, `cholesky_ex`, `cholesky_inverse`).  Returns
    {kernel: record}."""
    import torch
    from onephase_tpu_torch.models.qp import make_qp
    from onephase_tpu_torch.nlp import canonicalize
    from onephase_tpu_torch.ops import cholesky as ch
    from onephase_tpu_torch.ops import schur

    n, m, B = MIXED_SHAPE["n"], MIXED_SHAPE["m"], MIXED_SHAPE["batch"]
    nlp = canonicalize(make_qp(n, m, seed=0, device=dev),
                       dtype=torch.float64, device=dev)
    x0 = torch.zeros(1, n, dtype=torch.float64, device=dev)
    Jc = nlp.jac_orig(x0)[0].contiguous()
    H = nlp.lag_hess(x0, torch.zeros(1, nlp.m, dtype=torch.float64,
                                     device=dev))[0].contiguous()
    rng = np.random.default_rng(9)
    w = torch.as_tensor(10.0 ** rng.uniform(-4, 4, size=(B, m)),
                        dtype=torch.float64, device=dev)
    bnd = torch.as_tensor(rng.uniform(0.0, 5.0, size=(B, n)),
                          dtype=torch.float64, device=dev)
    f32 = [t.to(torch.float32) for t in (Jc, w, H, bnd)]
    Q = schur.pallas_fused_q(Jc, w, H, bnd)
    Q32 = Q.to(torch.float32)
    L = ch.pallas_chol(Q)[0]
    L32 = ch.pallas_chol(Q32)[0]
    bad64 = _baddbmm_operands(Jc, w, H, B)
    bad32 = _baddbmm_operands(*f32[:3], B)
    rec = {}
    for name, f64_fn, f32_fn, cast_fn, lib64, lib32, flops in (
            ("fused_q", lambda: schur.pallas_fused_q(Jc, w, H, bnd),
             lambda: schur.pallas_fused_q(*f32),
             lambda: [t.to(torch.float32) for t in (Jc, w, H, bnd)],
             lambda: torch.baddbmm(*bad64), lambda: torch.baddbmm(*bad32),
             B * m * n * (n + 1)),
            ("chol", lambda: ch.pallas_chol(Q), lambda: ch.pallas_chol(Q32),
             lambda: Q.to(torch.float32),
             lambda: torch.linalg.cholesky_ex(Q),
             lambda: torch.linalg.cholesky_ex(Q32), B * n ** 3 / 3),
            ("tri_inv_gram", lambda: ch.pallas_tri_inv_gram(L),
             lambda: ch.pallas_tri_inv_gram(L32),
             lambda: L.to(torch.float32),
             lambda: torch.cholesky_inverse(L),
             lambda: torch.cholesky_inverse(L32), 2 * B * n ** 3 / 3)):
        ms64, ms32, cast_ms, l64, l32 = _time_turns(f64_fn, f32_fn, cast_fn,
                                                    lib64, lib32)
        b64 = _bound(0, flops, "float64")[0]
        b32 = _bound(0, flops, "float32")[0]
        print(f"mixed {name} n={n} m={m} B={B}: float64 {ms64:.4f} ms, "
              f"float32 {ms32:.4f} ms (in turns; {ms32 / ms64:.2f}x), cast "
              f"to float32 {cast_ms:.4f} ms; library {l64:.4f} and "
              f"{l32:.4f} ms; operation bounds {b64:.4f} and {b32:.4f} ms",
              flush=True)
        rec[name] = {"ms_mixed_f64": ms64, "ms_mixed_f32": ms32,
                     "cast_ms_mixed": cast_ms, "library_ms_mixed_f64": l64,
                     "library_ms_mixed_f32": l32}
    return rec


def _rel_rows(x, ref):
    """max over rows of max |x - ref| / max |ref| (each row an instance);
    0 for no rows."""
    if x.shape[0] == 0:
        return 0.0
    return float(((x - ref).abs().amax(-1) / ref.abs().amax(-1)).max())


def mixed_phase(dev):
    """The precision knobs on the card.  MIXED_RUNS at MIXED_SHAPE in
    float64: "same" and "f32_fallback" certify every instance; "f32"
    certifies every instance the JAX package certifies
    (MIXED_JAX_F32_CERTIFIED) with K1-K3 launched on float32 operands;
    every certified argmin agrees with "same"'s to 1e-5 relative.  Then
    256/128/16 float32 with the bench options: `invchol` under
    residual_precision="f64", whose Optimal instances must all pass
    terminate_f64 at their final iterate, and `pallas` under
    q_form_dtype="bf16", which launches no Q kernel (the JAX package's
    dispatch forms the bf16 scale-split outside it).  Returns
    {run: summary}."""
    import torch
    from onephase_tpu_torch.ipm.state import OPTIMAL

    runs, states = {}, {}
    for name, extra in MIXED_RUNS.items():
        with _operand_dtypes() as seen:
            summary, st, _ = bench_run(
                dev, MIXED_SHAPE["n"], MIXED_SHAPE["m"], MIXED_SHAPE["batch"],
                "pallas", extra=extra, require_all=False,
                base=MIXED_OPTIONS, dtype="float64")
        summary["operand_dtypes"] = {k: sorted(v) for k, v in seen.items()}
        print(f"mixed {name}: K1-K3 operand dtypes "
              f"{summary['operand_dtypes']}", flush=True)
        runs[name], states[name] = summary, st
    # the mesh phase's unsharded M1 float64 batch
    runs["same"]["figures"] = _dense_figures(
        states["same"], runs["same"]["seconds"], runs["same"]["launches"])
    batch = MIXED_SHAPE["batch"]
    for name in ("same", "f32_fallback"):
        if runs[name]["solved"] != batch:
            raise RuntimeError(f"mixed {name}: {runs[name]['solved']}/"
                               f"{batch} certified")
    ok = {k: states[k].status == OPTIMAL for k in runs}
    certified = torch.nonzero(ok["f32"]).flatten().tolist()
    print(f"mixed f32: certified instances {certified}; the JAX package's "
          f"{MIXED_JAX_F32_CERTIFIED}", flush=True)
    if not set(MIXED_JAX_F32_CERTIFIED) <= set(certified):
        raise RuntimeError("mixed f32: an instance the JAX package "
                           "certifies was not certified")
    x_same = states["same"].p.x
    for name in ("f32", "f32_fallback"):
        both = ok[name] & ok["same"]
        diff = _rel_rows(states[name].p.x[both], x_same[both])
        print(f"mixed {name} argmin vs same's: max rel diff {diff:.3e} over "
              f"{int(both.sum())} instances", flush=True)
        if not diff <= 1e-5:
            raise RuntimeError(f"mixed {name}: argmins disagree")
    f32_run = runs["f32"]
    for k in ("fused_q", "chol", "tri_inv_gram"):
        if not (f32_run["launches"][k] > 0
                and f32_run["operand_dtypes"][k] == ["float32"]):
            raise RuntimeError(f"mixed f32: {k} launched "
                               f"{f32_run['launches'][k]} times on "
                               f"{f32_run['operand_dtypes'][k]}")

    # residual_precision="f64": every instance called Optimal passes the
    # float64 termination test at its final iterate
    # (no warm-up chunk: these two runs' seconds are not compared)
    res, st, kernel = bench_run(dev, 256, 128, 16, "invchol",
                                extra={"kkt.residual_precision": "f64"},
                                warmup=False, require_all=False)
    codes = kernel.terminate_f64(st.p, st.cache, st.bvals)
    opt = st.status == OPTIMAL
    honest = bool((codes[opt] == OPTIMAL).all())
    print(f"residual_precision f64 invchol: {int(opt.sum())}/16 Optimal, "
          f"each passes terminate_f64 at its final iterate: {honest}",
          flush=True)
    if not honest:
        raise RuntimeError("residual_precision f64: a certificate fails "
                           "the float64 termination test")
    runs["residual_f64_invchol"] = res
    # q_form_dtype="bf16": no Q kernel on the pallas lane
    bf, _, _ = bench_run(dev, 256, 128, 16, "pallas",
                         extra={"kkt.q_form_dtype": "bf16"},
                         warmup=False, require_all=False)
    print(f"q_form_dtype bf16 pallas: {bf['solved']}/16 Optimal, fused_q "
          f"launches {bf['launches']['fused_q']}", flush=True)
    if bf["launches"]["fused_q"] != 0:
        raise RuntimeError("q_form_dtype bf16 launched the Q kernel")
    runs["bf16_pallas"] = bf
    return runs


# the precision phase (Params.matmul_precision, ops/precision.py): K1 (and
# its lower mode, K3's Gram half), K2 and K3 in every mode of the card
# against their twins in the same mode, at the dense path's larger shape
# (n, m, B; K2 and K3 take n and B); the one-product checks take n = 256
PREC_SHAPE = (1024, 512, 64)
# max |kernel - twin| / max |twin|, by mode: the IEEE kernels' 1e-4
# (summation order; a mode's products are exact in float32), and 5e-4 for
# one-pass bf16, whose 8-bit operands turn a float32 summation difference
# into a product 2^-8 apart where an entry lies by a rounding boundary: K3
# at n=1024 put M 1.63e-4 from its twin while its own inverse held the
# bf16 recurrence 2965x closer than IEEE's (PERF.md §6); the residuals
# below hold each kernel to its mode's recurrence
PREC_TOL = {"bf16": 5e-4}
PREC_TOL_DEFAULT = 1e-4
# modes whose rounding must show at PREC_SHAPE: the kernel's output at
# least 10x closer to the recurrence it computes in its mode than in IEEE
# (`_prec_kernels`' residuals; a distance to the IEEE kernel, relative to
# the largest entry, drowns in float32 rounding at this size, PERF.md §6).
# Every mode's ratio is printed: the 3-, 6- and 9-product sets come within
# float32 rounding of IEEE (about 2^-16 a product and less, of the order
# of a 512-term float32 sum's), so the one-product checks hold every
# mode's arrival in every kernel (kernel and twin bit for bit; off the
# IEEE kernel wherever the mode takes at most 3 products)
PREC_REACH = ("tf32", "bf16", "f16")
# the bench QP (n, m, B) in float32 under these names (lane, name): the
# replay of the TPU's "highest" (6 bf16 passes) on the lane that runs
# K1-K3.  The others (the invchol lane, which launches no kernel, and the
# names that run to MAX_IT, 960 outer its, 26-47 s each on an H100,
# PERF.md §5) do not fit the script's time limit:
# tools/precision_bench.py runs them (PREC_BENCH_ALL)
PREC_BENCH_SHAPE = (256, 128, 16)
PREC_BENCH = (("pallas", "BF16_BF16_F32_X6"),)
PREC_BENCH_ALL = (("pallas", "high"), ("pallas", "BF16_BF16_F32"),
                  ("pallas", "BF16_BF16_F32_X3")) + PREC_BENCH + (
                      ("invchol", "BF16_BF16_F32_X6"), ("invchol", "high"))
# the TPU's records of that configuration on its invchol lane (TPU v5
# lite, f32, tol 1e-4; certified, outer its, factorizations)
PREC_TPU_INVCHOL = (
    '"highest" (6 bf16 passes) 16/16 (results/bench_sweep.md:5); '
    '"high" (3 passes) 12/16, 563, 965 (results/bench_sweep_prechigh.json); '
    '"default" (1 pass) 0/16, 960, 1026 '
    '(results/bench_sweep_precdefault.json)')


def _moded_f64(a, b, md):
    """a @ b with every product in mode `md`, each part product exact in
    float64 and the sum taken in float64: the mode's reference."""
    from onephase_tpu_torch.ops import precision
    pa = [p.double() for p in precision.split(a, md)]
    pb = [p.double() for p in precision.split(b, md)]
    return sum(pa[i] @ pb[j] for i, j in md.pairs)


def inverse_residual(L, X, md):
    """max |delta_rc - sum_{k<r} m(L[r, k], X[k, c]) - X[r, c] L[r, r]|
    over the lower triangle, every product m in mode `md` exact and the sum
    taken in float64 (`_moded_f64`): how far an inverse X of lower
    triangular L is from the recurrence of that mode (K3's inverse, and its
    twin)."""
    import torch
    s = _moded_f64(torch.tril(L, -1), X, md)
    d = torch.diagonal(L, dim1=-2, dim2=-1).double()
    eye = torch.eye(L.shape[-1], dtype=torch.float64, device=L.device)
    return float((eye - s - X.double() * d[:, :, None]).tril().abs().max())


def _prec_kernels(dev, n, m, B):
    """({name: (kernel(mode), twin(mode), operations, (input(mode) or
    None, residual(out, mode)))}, (Jc, w, H)) at one shape.  K1 on the kernel phase's Jc, w and
    bnd with H = None (the rank-m product alone, where a mode acts), K1's
    lower mode on an L^-1, K2 on an SPD Q, K3 on that Q's factor; the same
    inputs for every mode.  `residual` is the largest distance of the
    kernel's own output from the recurrence it computes with every product
    taken in `mode` (float64, exact part products): for K1 and its Gram
    mode the product itself (the lower triangle, which the path reads), for
    K2 L[i, j] L[j, j] = Q[i, j] - sum_{k<j} m(L[i, k], L[j, k]), for K3
    its inverse half, X[r, c] L[r, r] = delta_rc - sum_{k<r} m(L[r, k],
    X[k, c]).  It is small in the kernel's own mode (float32 sums) and
    large in another one; taken on the kernel's output, no rounding of an
    operand can fall the other way."""
    import torch
    from onephase_tpu_torch.ops import cholesky as ch
    from onephase_tpu_torch.ops import precision, schur

    rng = np.random.default_rng(n + B)
    f32 = torch.float32
    Jc = torch.as_tensor(rng.normal(size=(m, n)) / np.sqrt(n), dtype=f32,
                         device=dev)
    w = torch.as_tensor(rng.uniform(0.1, 10.0, size=(B, m)), dtype=f32,
                        device=dev)
    H = None
    bnd = torch.as_tensor(rng.uniform(0.0, 5.0, size=(B, n)), dtype=f32,
                          device=dev)
    Q = _spd(rng, B, n, f32, dev)
    L = ch.pallas_chol(Q, mode=precision.IEEE)[0]
    Li = torch.empty_like(L)
    ch.launch_tri_inv(L, Li)

    def gram(md):
        G = torch.empty_like(Li)
        schur.launch_fused_q(Li, None, None, None, G, lower=True, mode=md)
        return G

    def res_k1(out, md):
        ref = _moded_f64((Jc * w[:, :, None]).mT, Jc, md) + \
            torch.diag_embed(bnd.double())
        return float((out.double() - ref).tril().abs().max())

    def res_gram(out, md):
        return float((out.double() - _moded_f64(Li.mT, Li, md)).tril()
                     .abs().max())

    def res_chol(out, md):
        d = torch.diagonal(out, dim1=-2, dim2=-1)
        s = _moded_f64(out, out.mT, md)
        # less the k = j term of each entry, m(L[i, j], L[j, j])
        s -= sum(pi.double() * pj.double()[:, None, :] for (pi, pj) in (
            (precision.split(out, md)[i], precision.split(d, md)[j])
            for i, j in md.pairs))
        r = Q.double() - s - out.double() * d.double()[:, None, :]
        return float(r.tril().abs().max())

    def inverse(md):
        X = torch.empty_like(L)
        ch.launch_tri_inv(L, X, md)
        return X

    # name: kernel, twin, operations, (what the residual reads, residual)
    return {
        "K1": (lambda md: schur.pallas_fused_q(Jc, w, H, bnd, mode=md),
               lambda md: schur.xla_fused_q(Jc, w, H, bnd, mode=md),
               B * m * n * (n + 1), (None, res_k1)),
        "K1_lower": (gram, lambda md: precision.matmul(Li.mT, Li, md),
                     B * n ** 3 / 3, (None, res_gram)),
        "K2": (lambda md: ch.pallas_chol(Q, mode=md)[0],
               lambda md: ch.blocked_chol(Q, md)[0], B * n ** 3 / 3,
               (None, res_chol)),
        "K3": (lambda md: ch.pallas_tri_inv_gram(L, mode=md),
               lambda md: ch.xla_chol_inv_from_L(L, md), 2 * B * n ** 3 / 3,
               (inverse, lambda X, md: inverse_residual(L, X, md))),
    }, (Jc, w, H, Q, L)


def one_product_operands(B, n, seed, device):
    """(Q, L), float32 (B, n, n), on which K2 and K3 take at most one
    product of two nonzero entries for an entry of their output, outside
    every diagonal block: row i >= n/2 has one off-diagonal entry a_i, at
    column c = i - n/2, and no other row has one in that column (n/2 >=
    128: c lies in an earlier 64-column panel of K2 and an earlier 32-row
    chunk of K3).  Q has a unit diagonal above n/2, Q[i, c] = a_i and
    Q[i, i] = a_i^2 + 1/4, so K2's factor has L[c, c] = 1, L[i, c] = a_i
    and L[i, i] from the pivot 1/4 + a_i^2 - m(a_i, a_i), the product m
    taken in a trailing update; L is unit lower triangular with
    L[i, c] = a_i, so K3's inverse has X[i, c] = -m(a_i, 1), taken in a
    block update.  Both updates sum the mode's part products from +0 and
    subtract the sum, as the twins do, and the divisions are by 1, so a
    kernel and its twin agree bit for bit in every mode."""
    import torch
    h = n // 2
    a = torch.as_tensor(np.random.default_rng(seed).normal(size=(B, h)),
                        dtype=torch.float32)
    i, c = torch.arange(h, n), torch.arange(h)
    L = torch.eye(n).repeat(B, 1, 1)
    L[:, i, c] = a
    Q = L.clone()
    Q[:, c, i] = a
    Q[:, i, i] = (a.double() ** 2 + 0.25).float()
    return Q.to(device), L.to(device)


def _prec_one_product(dev):
    """Every mode reaches K1, its lower mode, K2 and K3: on inputs with one
    product an entry (K1: one constraint row; its lower mode: an L^-1 whose
    last row alone is nonzero; K2, K3: `one_product_operands`) each kernel
    equals its twin bit for bit in every card mode, and, where the mode
    takes at most 3 products, differs from the IEEE kernel (the 6- and
    9-product sets may round to the IEEE product).  So a kernel that ran
    IEEE in place of a mode fails, whatever the mode."""
    import torch
    from onephase_tpu_torch.ops import cholesky as ch
    from onephase_tpu_torch.ops import precision, schur
    rng = np.random.default_rng(4)
    n, B = 256, 4
    Jc = torch.as_tensor(rng.normal(size=(1, n)), dtype=torch.float32,
                         device=dev)
    w = torch.as_tensor(rng.uniform(0.1, 10.0, size=(B, 1)),
                        dtype=torch.float32, device=dev)
    bnd = torch.zeros(B, n, device=dev)
    Li = torch.zeros(B, n, n, device=dev)
    Li[:, -1] = torch.as_tensor(rng.normal(size=(B, n)), dtype=torch.float32,
                                device=dev)
    Q, L = one_product_operands(B, n, 5, dev)

    def gram(md):
        G = torch.empty_like(Li)
        schur.launch_fused_q(Li, None, None, None, G, lower=True, mode=md)
        return G.tril()

    def inverse(md):
        X = torch.empty_like(L)
        ch.launch_tri_inv(L, X, md)
        return X

    # name: (kernel(mode), twin(mode))
    pairs = {
        "K1": (lambda md: schur.pallas_fused_q(Jc, w, None, bnd,
                                               mode=md).tril(),
               lambda md: schur.xla_fused_q(Jc, w, None, bnd,
                                            mode=md).tril()),
        "K1_lower": (gram,
                     lambda md: precision.matmul(Li.mT, Li, md).tril()),
        "K2": (lambda md: ch.pallas_chol(Q, mode=md)[0],
               lambda md: ch.blocked_chol(Q, md)[0]),
        "K3": (inverse, lambda md: ch.blocked_tri_inv(L, mode=md)),
    }
    for name, (kern, twin) in pairs.items():
        ieee = kern(precision.IEEE)
        out = []
        for md in precision.CARD_MODES:
            got = kern(md)
            same = torch.equal(got, twin(md))
            moved = int((got != ieee).sum())
            out.append(f"{md} {'=' if same else 'DIFFERS'} ({moved} "
                       "entries off IEEE)")
            if not same:
                raise RuntimeError(f"precision: one-product {name} in {md} "
                                   "is not its twin bit for bit")
            if md.passes <= 3 and moved == 0:
                raise RuntimeError(f"precision: one-product {name} in {md} "
                                   "is the IEEE kernel's, bit for bit")
        print(f"precision one-product {name} vs twin: {'; '.join(out)}",
              flush=True)


def precision_kernel_checks(dev):
    """The kernels in every card mode against their twins (PREC_TOL), the
    reach criterion on PREC_REACH (the kernel's output within the mode's
    recurrence at least 10x closer than within IEEE's), timed in turns
    with the IEEE kernel (the twin once, by its comparison call), beside
    the bound: the larger of the bytes over the memory rate and
    operations x products a pass set over the tensor cores' rate for the
    mode's input type (TF32 495, bf16 and fp16 989 TFLOP/s), and the same
    products over the FP32 rate (`ffma_bound_ms`).  Returns {kernel:
    {mode: record}}."""
    import torch
    from onephase_tpu_torch.ops import precision

    _prec_one_product(dev)
    rec = {}
    n, m, B = PREC_SHAPE
    kernels, (Jc, w, H, Q, L) = _prec_kernels(dev, n, m, B)
    for name, (kern, twin, flops, (rin, residual)) in kernels.items():
        # K1's two modes: compared on the lower triangle
        view = torch.tril if name.startswith("K1") else (lambda t: t)
        parts = []
        # each input read once, each output written once (float32)
        nbytes = 4 * (B * n * n + (m * n + B * m + B * n
                                   if name == "K1" else B * n * n))
        for md in precision.CARD_MODES:
            out = kern(md)
            # the twin timed once, by its comparison call
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            tw = twin(md)
            end.record()
            torch.cuda.synchronize()
            twin_ms = start.elapsed_time(end)
            got, tw = view(out), view(tw)
            d_twin, d_twin_abs = _err(got, tw)
            # the residual reads the output (K3: its inverse half)
            rout = out if rin is None else rin(md)
            r_mode = residual(rout, md)
            r_ieee = residual(rout, precision.IEEE)
            ratio = r_ieee / max(r_mode, 1e-30)
            del out, got, tw, rout
            times = _time_turns(lambda: kern(md),
                                lambda: kern(precision.IEEE), reps=5)
            # the bound at the mode's input type's tensor-core rate; beside
            # it, the same products on the FP32 cores (where K3's moded
            # inverse runs them)
            bound, bound_by = _bound(nbytes, flops * md.passes, md.kind)
            ffma = flops * md.passes / PEAK_FLOPS["float32"] * 1e3
            part = (f"{md} err {d_twin:.2e}, residual {r_mode:.2e} "
                    f"(IEEE's {r_ieee:.2e}, {ratio:.1f}x) "
                    f"{times[0]:.4f} ms vs IEEE {times[1]:.4f} twin "
                    f"{twin_ms:.4f} bound {bound:.4f} ({bound_by}; on the "
                    f"FP32 cores {ffma:.4f})")
            parts.append(part)
            if name != "K1_lower":
                key = {"K1": "fused_q", "K2": "chol",
                       "K3": "tri_inv_gram"}[name]
                rec.setdefault(key, {})[str(md)] = {
                    "max_abs_err": d_twin_abs, "ms": times[0],
                    "ieee_ms": times[1], "plain_ms": twin_ms,
                    "bound_ms": bound, "bound_by": bound_by,
                    "ffma_bound_ms": ffma, "library_ms": None,
                    "rel_to_twin": d_twin, "residual": r_mode,
                    "residual_ieee": r_ieee}
            if not d_twin <= PREC_TOL.get(str(md), PREC_TOL_DEFAULT):
                raise RuntimeError(f"precision: {name} n={n} in {md} "
                                   f"disagrees with its twin: {part}")
            if str(md) in PREC_REACH and not ratio >= 10:
                raise RuntimeError(f"precision: {name} n={n} in {md} "
                                   f"does not show its mode: {part}")
        print(f"precision {name} n={n} m={m} B={B}: " + "; ".join(parts),
              flush=True)
    _prec_library(kernels["K1"][0], (Jc, w, H, Q, L), rec)
    _prec_chol_phases(Q, rec)
    return rec


def _prec_library(k1, operands, rec):
    """The library yardsticks of the moded kernels at PREC_SHAPE, each one
    PyTorch call on the same operands, timed in turns with the kernel: K1
    in one-pass TF32 against `baddbmm` with cuBLAS's TF32 on, in one-pass
    bf16 and fp16 against `baddbmm` on operands of that type with a
    float32 result (`out_dtype`, where the installed torch takes it); K2
    in every mode against `cholesky_ex`, K3 against `cholesky_inverse`
    (IEEE, timed once).  The split modes have none."""
    import torch
    from onephase_tpu_torch.ops import precision
    Jc, w, H, Q, L = operands
    B = w.shape[0]
    Hb, A, Jb = _baddbmm_operands(Jc, w, H, B)
    saved = torch.backends.cuda.matmul.allow_tf32

    def tf32_baddbmm():
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.baddbmm(Hb, A, Jb)
        torch.backends.cuda.matmul.allow_tf32 = saved

    parts = []
    ms, lms = _time_turns(lambda: k1(precision.TF32), tf32_baddbmm)
    parts.append(f"tf32 kernel {ms:.4f} ms, baddbmm with cuBLAS TF32 "
                 f"{lms:.4f}")
    rec["fused_q"]["tf32"]["library_ms"] = lms
    for kind, dt in (("bf16", torch.bfloat16), ("f16", torch.float16)):
        a, b = A.to(dt), Jb.to(dt)
        try:
            torch.baddbmm(Hb, a, b, out_dtype=torch.float32)
        except (TypeError, RuntimeError) as e:
            parts.append(f"{kind}: none (baddbmm takes no out_dtype here: "
                         f"{str(e).splitlines()[0][:80]})")
            continue
        ms, lms = _time_turns(
            lambda: k1(precision.Mode(kind, 1)),
            lambda: torch.baddbmm(Hb, a, b, out_dtype=torch.float32))
        parts.append(f"{kind} kernel {ms:.4f} ms, baddbmm on {kind} "
                     f"operands, float32 out {lms:.4f}")
        rec["fused_q"][kind]["library_ms"] = lms
        del a, b
    chol_ms = _time_ms(lambda: torch.linalg.cholesky_ex(Q))
    inv_ms = _time_ms(lambda: torch.cholesky_inverse(L))
    for md in rec["chol"]:
        rec["chol"][md]["library_ms"] = chol_ms
        rec["tri_inv_gram"][md]["library_ms"] = inv_ms
    parts.append(f"K2 cholesky_ex {chol_ms:.4f}; K3 cholesky_inverse "
                 f"{inv_ms:.4f}")
    print(f"precision library (in turns): {'; '.join(parts)}", flush=True)


def _prec_chol_phases(Q, rec):
    """K2's time by phase in IEEE and every card mode at PREC_SHAPE
    (`ops/cholesky.py:chol_phases`, the clocked copy of csrc/chol.cu), each
    split mode's time beside `cholesky_ex` (`rec`, the precision records),
    K2 in float64 on the same Q against `cholesky_ex` in turns with its
    bound and phase split, and the moded kernels' registers and spills
    from the build log."""
    import torch
    from onephase_tpu_torch.ops import _build
    from onephase_tpu_torch.ops import cholesky as ch
    from onephase_tpu_torch.ops import precision
    for md in (precision.IEEE,) + precision.CARD_MODES:
        ph = ch.chol_phases(Q, md)
        print(f"precision K2 phases {md}: " + ", ".join(
            f"{p} {v * 100:.1f}%" for p, v in ph["share"].items())
            + f" ({ph['cycles']:.0f} cycles a block, cluster "
            f"{ph['cluster']})", flush=True)
    split = [(str(md), rec["chol"][str(md)]) for md in precision.CARD_MODES
             if md.passes > 1]
    print("precision K2 split modes beside cholesky_ex: " + "; ".join(
        f"{md} {r['ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x "
        f"{r['library_ms']:.4f})" for md, r in split), flush=True)
    B, n = Q.shape[0], Q.shape[-1]
    Q64 = Q.double()
    ms, lms = _time_turns(lambda: ch.pallas_chol(Q64),
                          lambda: torch.linalg.cholesky_ex(Q64))
    bd = _bound(8 * (2 * B * n * n + B * n) + B, B * n ** 3 / 3, "float64")
    ph = ch.chol_phases(Q64)
    print(f"precision K2 float64 n={n} B={B}: {ms:.4f} ms, cholesky_ex "
          f"{lms:.4f} ms ({ms / lms:.2f}x, in turns), bound {bd[0]:.4f} ms "
          f"({bd[1]}); phases " + ", ".join(
              f"{p} {v * 100:.1f}% {v * ms:.4f} ms"
              for p, v in ph["share"].items())
          + f" (cluster {ph['cluster']})", flush=True)
    rep = _ptxas_report(_build.BUILD_LOG, ("fused_q_wg_kernel",
                                            "fused_q_tc_kernel",
                                            "chol_kernel"))
    moded = [f"{k}: " + ", ".join(x.strip() for x in rep[i + 1:i + 3])
             for i, k in enumerate(rep)
             if k.startswith(("fused_q_wg_kernel", "fused_q_tc_kernel",
                              "chol_kernel<float, true"))]
    print("precision ptxas (the moded kernels): " + "; ".join(moded),
          flush=True)


# K7 and K5 in every card mode (the matmul modes of csrc/tridiag.cu): at
# the chain path's and the banded path's shapes (K, nb), timed alone in
# the precision phase and held to their twins beside the later phases
# (`tridiag_mode_phase`); the chain path under one single-pass name and one
# split name on `pallas`, beside its IEEE run
TRIDIAG_MODE_SHAPES = ((CHAIN_SHAPE["K"], CHAIN_SHAPE["nx"]),
                       (BANDED_BAND["K"], BANDED_BAND["nb"]))
CHAIN_MODE_RUNS = ("high", "BF16_BF16_F32_X6")
# max |kernel - twin| / max |twin| for K7 and K5: in a one-pass mode 8 u,
# u the unit roundoff of the mode's input type.  Kernel and twin sum in
# other orders, so an operand a float32 rounding apart can round to the
# mode's neighbouring value, a step of u that the rest of the recursion
# carries on (K7 against the whole recursion in TF32 at K = 40, nb = 32:
# 3.1e-4, 0.64 u, on an H100);
# the split modes represent an operand to 2^-16 or closer, and take
# PREC_TOL_DEFAULT.  Each kernel's own output is also held to its mode's
# recurrences (`_tridiag_factor_residual`, TRIDIAG_RESIDUAL_TOL)
TRIDIAG_UNIT_ROUNDOFF = {"tf32": 2.0 ** -11, "bf16": 2.0 ** -8,
                         "f16": 2.0 ** -11}
# K7's recurrences on its own entries, float64 with exact part products,
# over the magnitudes of each entry's terms: float32 sums of at most 64
# terms (and the reach criterion of PREC_REACH: 10x closer than IEEE's)
TRIDIAG_RESIDUAL_TOL = 1e-5


def _tridiag_tol(md):
    """K7's and K5's tolerance against their twins in mode `md`."""
    if md.passes == 1:
        return 8 * TRIDIAG_UNIT_ROUNDOFF[md.kind]
    return PREC_TOL_DEFAULT


def _tridiag_factor_residual(Ck, Ci, Ek, Ad, Bs, delta, md):
    """The largest error of K7's recurrences in mode `md` on a factor's own
    entries (float64, exact part products: `_moded_f64`), over the
    magnitudes of each entry's terms, all stages at once: S_k = A_k +
    delta I - m(E_{k-1} E_{k-1}^T); C[i, j] C[j, j] = S[i, j] -
    sum_{q<j} m(C[i, q], C[j, q]); Ci[r, c] C[r, r] = delta_rc -
    sum_{q<r} m(C[r, q], Ci[q, c]); E_k = m(B_k Ci_k^T)."""
    import torch
    from onephase_tpu_torch.ops import precision
    f64 = torch.float64
    nb = Ad.shape[-1]
    eye = torch.eye(nb, dtype=f64, device=Ad.device)
    low = torch.ones(nb, nb, dtype=torch.bool, device=Ad.device).tril()

    def mag(a, b):
        return a.double().abs() @ b.double().abs()

    def worst(err, scale, where=None):
        r = err.abs() / scale.clamp_min(1e-30)
        return float((r if where is None else r[..., where]).max())

    S = Ad.double() + delta.double()[:, None, None, None] * eye
    mS = S.abs()
    if Ek.shape[1]:
        S[:, 1:] -= _moded_f64(Ek, Ek.mT, md)
        mS[:, 1:] += mag(Ek, Ek.mT)
    d = torch.diagonal(Ck, dim1=-2, dim2=-1)
    # sum over q < j only: less each entry's q = j term, m(C[i, j], C[j, j])
    parts_c, parts_d = precision.split(Ck, md), precision.split(d, md)
    self_term = sum(parts_c[i].double() * parts_d[j].double()[..., None, :]
                    for i, j in md.pairs)
    lhs = Ck.double() * d.double()[..., None, :]
    rhs = S - (_moded_f64(Ck, Ck.mT, md) - self_term)
    errs = [worst(lhs - rhs, mS + mag(Ck, Ck.mT) + lhs.abs(), low)]
    strict = torch.tril(Ck, -1)
    lhs = Ci.double() * d.double()[..., :, None]
    errs.append(worst(lhs - (eye - _moded_f64(strict, Ci, md)),
                      1 + mag(strict, Ci) + lhs.abs(), low))
    if Ek.shape[1]:
        errs.append(worst(Ek.double() - _moded_f64(Bs, Ci[:, :-1].mT, md),
                          mag(Bs, Ci[:, :-1].mT)))
    return max(errs)


def tridiag_one_product_operands(K, nb, seed, device):
    """((Ad, Bs, delta), (Ci, Ek, b)): one instance (a leading axis of 1)
    in float32 on which K7 and K5 take at most one product of two nonzero
    entries for an entry of every product they form, so that a kernel and
    its twin, which sum a dot product's terms and a product's parts in
    other orders, agree bit for bit in every mode.  With h = nb // 2 and
    rows i in [h, 2h), c = i - h:
    - K7: A_k has 4 on the diagonal of rows c < h, A[i, c] = A[c, i] = a
      and A[i, i] = 1 + a^2 (1 past 2h); B_k has one entry a row, B[c, i].
      So C_k has column c's one entry below the diagonal at row i (one
      product in the pivot of row i), C_k^-1 row i entries at c and i (one
      product at c), E_k = B_k Ci_k^T one entry a row, at column i (column
      i of Ci_k holds its diagonal alone), and E_k E_k^T is diagonal, one
      product an entry, for the next stage.
    - K5: Ci_k diagonal, E_k a scaled permutation (one entry a row and a
      column), so every matvec entry of both sweeps is one product; |Ci_k|
      <= 1.5 and |E_k| <= 0.5 keep the sweeps' vectors bounded, within
      fp16's range at any K.
    Every sum of products starts from +0 and is subtracted where the
    recurrence subtracts it, in kernel and twin alike (csrc/tridiag.cu)."""
    import torch
    rng = np.random.default_rng(seed)
    h = nb // 2
    i, c = np.arange(h, 2 * h), np.arange(h)
    a = rng.normal(size=(K, h)).astype(np.float32)
    Ad = np.zeros((K, nb, nb), np.float32)
    Ad[:, np.arange(nb), np.arange(nb)] = 1.0
    Ad[:, c, c] = 4.0
    Ad[:, i, i] = 1.0 + a.astype(np.float64) ** 2
    Ad[:, i, c] = a
    Ad[:, c, i] = a
    Bs = np.zeros((max(K - 1, 0), nb, nb), np.float32)
    Bs[:, c, i] = 0.3 * rng.normal(size=(max(K - 1, 0), h))
    Ci = np.zeros((K, nb, nb), np.float32)
    Ci[:, np.arange(nb), np.arange(nb)] = rng.uniform(0.5, 1.5, (K, nb))
    Ek = np.zeros((max(K - 1, 0), nb, nb), np.float32)
    for k in range(K - 1):
        Ek[k, np.arange(nb), rng.permutation(nb)] = rng.choice(
            [-1.0, 1.0], nb) * rng.uniform(0.1, 0.5, nb)
    b = rng.normal(size=(K, nb)).astype(np.float32)

    def t(x):
        return torch.as_tensor(x[None], device=device)
    return (t(Ad), t(Bs), 1e-3), (t(Ci), t(Ek), t(b))


def _tridiag_mode_operands(rng, K, nb, dev):
    """((Ad, Bs, delta), (Ci, Ek, b)), float32, two instances: 0 the kernel
    phase's kind of SPD band (Ci and Ek its IEEE factor's), 1 the
    one-product operands."""
    import torch
    from onephase_tpu_torch.ops import precision
    from onephase_tpu_torch.ops import tridiag_pallas as tp
    f32 = torch.float32
    Ad0, Bs0 = _band(rng, 1, K, nb, f32, dev)
    _, Ci0, Ek0, _ = tp.pallas_tridiag_factor(Ad0, Bs0, 1e-4,
                                              mode=precision.IEEE)
    b0 = torch.as_tensor(rng.normal(size=(1, K, nb)), dtype=f32, device=dev)
    (Ad1, Bs1, d1), (Ci1, Ek1, b1) = tridiag_one_product_operands(
        K, nb, K + nb, dev)
    delta = torch.tensor([1e-4, d1], dtype=f32, device=dev)
    return ((torch.cat([Ad0, Ad1]), torch.cat([Bs0, Bs1]), delta),
            (torch.cat([Ci0, Ci1]), torch.cat([Ek0, Ek1]),
             torch.cat([b0, b1])))


def _shape_key(K, nb):
    """The records' key suffix of a tridiagonal shape: "" for the chain's,
    "_banded" for the banded path's."""
    return "" if (K, nb) == TRIDIAG_MODE_SHAPES[0] else "_banded"


def tridiag_mode_times(dev):
    """K7 and K5 in every card mode at TRIDIAG_MODE_SHAPES (one instance,
    the kernel phase's kind of band), each timed in turns with the IEEE
    kernel (medians of 5) beside its bound: the larger of the bytes over
    the memory rate and the operations x products a pass set over the
    tensor cores' rate for the mode's input type, and the same products
    over the FP32 rate (`ffma_bound_ms`), where the kernels run them.
    Runs alone on the card (the precision phase).  Returns {kernel: {mode:
    record}}."""
    import torch
    from onephase_tpu_torch.ops import precision
    from onephase_tpu_torch.ops import tridiag_pallas as tp
    rec = {"tridiag_factor": {}, "tridiag_solve": {}}
    rng = np.random.default_rng(2)
    ieee = precision.IEEE
    for K, nb in TRIDIAG_MODE_SHAPES:
        Ad, Bs = _band(rng, 1, K, nb, torch.float32, dev)
        _, Ci, Ek, _ = tp.pallas_tridiag_factor(Ad, Bs, 1e-4, mode=ieee)
        b = torch.as_tensor(rng.normal(size=(1, K, nb)),
                            dtype=torch.float32, device=dev)
        work = dict(zip(rec, _tridiag_work(1, K, nb, 4)))
        key = _shape_key(K, nb)
        parts = []
        for md in precision.CARD_MODES:
            times = {
                "tridiag_factor": _time_turns(
                    lambda: tp.pallas_tridiag_factor(Ad, Bs, 1e-4, mode=md),
                    lambda: tp.pallas_tridiag_factor(Ad, Bs, 1e-4,
                                                     mode=ieee), reps=5),
                "tridiag_solve": _time_turns(
                    lambda: tp.pallas_tridiag_solve(Ci, Ek, b, mode=md),
                    lambda: tp.pallas_tridiag_solve(Ci, Ek, b, mode=ieee),
                    reps=5)}
            line = []
            for name, (ms, ieee_ms) in times.items():
                nbytes, flops = work[name]
                bound, bound_by = _bound(nbytes, flops * md.passes, md.kind)
                ffma = flops * md.passes / PEAK_FLOPS["float32"] * 1e3
                rec[name].setdefault(str(md), {}).update({
                    f"ms{key}": ms, f"ieee_ms{key}": ieee_ms,
                    f"bound_ms{key}": bound, f"bound_by{key}": bound_by,
                    f"ffma_bound_ms{key}": ffma})
                line.append(f"{'K7' if name == 'tridiag_factor' else 'K5'} "
                            f"{ms:.4f} ms vs IEEE {ieee_ms:.4f} bound "
                            f"{bound:.4f} ({bound_by}; on the FP32 cores "
                            f"{ffma:.4f})")
            parts.append(f"{md} " + ", ".join(line))
        print(f"precision K7/K5 K={K} nb={nb} f32 (alone, in turns): "
              + "; ".join(parts), flush=True)
    return rec


def tridiag_factor_stages(Ad, Bs, delta, Ek, md):
    """K7's twin in mode `md`, every stage at once from a factor's own
    carried blocks: `moded_factor_stage` (the twin's stage, which
    `xla_tridiag_factor_inv` runs stage after stage) on the (B K) blocks
    A_k with E_{k-1} = Ek[k-1] (zero at k = 0) and B_k (zero at k = K-1),
    as the repo's parity tests step the JAX package's recursion from the
    port's carried state.  Returns (Ck, Ci, Ek, ok) shaped as K7's."""
    import torch
    from onephase_tpu_torch.ops import tridiag_pallas as tp
    B, K, nb, _ = Ad.shape
    zero = Ad.new_zeros(B, 1, nb, nb)

    def flat(t):
        return t.reshape(B * K, nb, nb)
    C, Ci, E, ok = tp.moded_factor_stage(
        flat(Ad), flat(torch.cat([Bs, zero], 1)),
        flat(torch.cat([zero, Ek], 1)), delta.repeat_interleave(K), md)
    return (C.reshape(B, K, nb, nb), Ci.reshape(B, K, nb, nb),
            E.reshape(B, K, nb, nb)[:, :K - 1], ok.reshape(B, K).all(1))


def _event_ms(fn):
    """(fn(), its time in ms between two CUDA events)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def tridiag_mode_phase(dev):
    """K7 and K5 in every card mode against their twins in the same mode
    (K7's stage by stage from its own carried E_{k-1}, all stages in one
    batched call: `tridiag_factor_stages`; K5's the whole recursion,
    `xla_tridiag_solve_inv` with the mode) at TRIDIAG_MODE_SHAPES on two
    instances (`_tridiag_mode_operands`): the
    band within `_tridiag_tol` (max |kernel - twin| / max |twin| over Ck,
    Ci, Ek and over x), K7's output on it within TRIDIAG_RESIDUAL_TOL of
    its mode's recurrences (and, in the modes of PREC_REACH, 10x closer
    than the IEEE kernel's), the one-product instance bit for bit, and off
    the IEEE kernel there wherever the mode takes at most 3 products (a
    kernel that ran IEEE in place of a mode fails).  Then the chain path on
    `pallas` under CHAIN_MODE_RUNS, K5 and K7 launched in the run's mode.
    A later phase (beside the others on the card): the twins' times are
    taken there.  Returns {"records": {kernel: {mode: record}}, "chain":
    {name: (summary, x as numpy)}}."""
    import torch
    from onephase_tpu_torch.ops import precision
    from onephase_tpu_torch.ops import tridiag_pallas as tp
    t0 = time.perf_counter()
    rec = {"tridiag_factor": {}, "tridiag_solve": {}}
    rng = np.random.default_rng(6)
    ieee = precision.IEEE
    for K, nb in TRIDIAG_MODE_SHAPES:
        (Ad, Bs, delta), (Ci, Ek, b) = _tridiag_mode_operands(rng, K, nb,
                                                              dev)
        i7 = tp.pallas_tridiag_factor(Ad, Bs, delta, mode=ieee)
        i5 = tp.pallas_tridiag_solve(Ci, Ek, b, mode=ieee)
        key = _shape_key(K, nb)
        parts = []
        for md in precision.CARD_MODES:
            k7 = tp.pallas_tridiag_factor(Ad, Bs, delta, mode=md)
            k5 = tp.pallas_tridiag_solve(Ci, Ek, b, mode=md)
            t7, p7 = _event_ms(
                lambda: tridiag_factor_stages(Ad, Bs, delta, k7[2], md))
            t5, p5 = _event_ms(
                lambda: tp.xla_tridiag_solve_inv(Ci, Ek, b, mode=md))
            if not (bool(k7[3].all()) and bool(t7[3].all())):
                raise RuntimeError(f"precision K7 K={K} nb={nb} in {md}: "
                                   "an SPD band rejected")
            errs7 = [_err(k[0], t[0]) for k, t in zip(k7[:3], t7[:3])
                     if k.shape[1] > 0]
            e7 = max(e for e, _ in errs7), max(a for _, a in errs7)
            e5 = _err(k5[0], t5[0])
            same7 = all(torch.equal(k[1], t[1]) for k, t in zip(k7, t7))
            same5 = torch.equal(k5[1], t5[1])
            moved7 = sum(int((k[1] != i[1]).sum())
                         for k, i in zip(k7[:3], i7[:3]))
            moved5 = int((k5[1] != i5[1]).sum())
            # K7's output against its mode's recurrences, and the IEEE
            # kernel's against the same
            r_mode = _tridiag_factor_residual(*k7[:3], Ad, Bs, delta, md)
            r_ieee = _tridiag_factor_residual(*i7[:3], Ad, Bs, delta, md)
            tol = _tridiag_tol(md)
            part = (f"{md} K7 err {e7[0]:.2e} (tol {tol:.1e}), residual "
                    f"{r_mode:.2e} (IEEE's {r_ieee:.2e}, "
                    f"{r_ieee / max(r_mode, 1e-30):.1f}x), one-product "
                    f"{'=' if same7 else 'DIFFERS'} ({moved7} entries off "
                    f"IEEE), twin's stages {p7:.1f} ms; K5 err "
                    f"{e5[0]:.2e}, "
                    f"one-product {'=' if same5 else 'DIFFERS'} ({moved5} "
                    f"off IEEE), twin {p5:.2f} ms")
            parts.append(part)
            for name, e, p_ms in (("tridiag_factor", e7, p7),
                                  ("tridiag_solve", e5, p5)):
                plain = "plain_stages_ms" if name == "tridiag_factor" \
                    else "plain_ms"
                rec[name].setdefault(str(md), {}).update({
                    f"max_abs_err{key}": e[1], f"rel_to_twin{key}": e[0],
                    f"{plain}{key}": p_ms, "library_ms": None})
            rec["tridiag_factor"][str(md)].update({
                f"residual{key}": r_mode, f"residual_ieee{key}": r_ieee})
            if not (e7[0] <= tol and e5[0] <= tol):
                raise RuntimeError(f"precision K7/K5 K={K} nb={nb} in {md} "
                                   f"disagree with their twins: {part}")
            if not r_mode <= TRIDIAG_RESIDUAL_TOL or (
                    str(md) in PREC_REACH and not r_ieee >= 10 * r_mode):
                raise RuntimeError(f"precision K7 K={K} nb={nb} in {md} "
                                   f"does not hold its recurrences: {part}")
            if not (same7 and same5):
                raise RuntimeError(f"precision K7/K5 K={K} nb={nb} in {md}: "
                                   f"one-product not bit for bit: {part}")
            if md.passes <= 3 and not (moved7 and moved5):
                raise RuntimeError(f"precision K7/K5 K={K} nb={nb} in {md}: "
                                   f"one-product equal to IEEE: {part}")
        print(f"precision K7/K5 K={K} nb={nb} f32 vs twins: "
              + "; ".join(parts), flush=True)
    chain = {}
    for name in CHAIN_MODE_RUNS:
        summary, x = chain_run(dev, "pallas", name)
        chain[name] = (summary, x.cpu().numpy())
    print(f"precision K7/K5 phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"records": rec, "chain": chain}


def precision_bench(dev, runs, seed=0):
    """The bench QP at PREC_BENCH_SHAPE in float32 under each (lane, name)
    of `runs` (the QP and starts from `seed`, as `bench_run`), printed
    beside the TPU's records: every run ends with valid statuses and, on
    `pallas`, K1-K3 launched in the run's mode.  Returns {(lane, name):
    summary}."""
    from onephase_tpu_torch.ipm.state import RUNNING, STATUS_NAMES
    from onephase_tpu_torch.ops import precision

    valid = {v for k, v in STATUS_NAMES.items() if k != RUNNING}
    out = {}
    for lane, name in runs:
        res, _, _ = bench_run(dev, *PREC_BENCH_SHAPE, lane,
                              extra={"matmul_precision": name},
                              warmup=False, require_all=False, seed=seed)
        mode = str(precision.resolve(name, "cuda"))
        modes = {k: res["launch_modes"].get(k, {})
                 for k in ("fused_q", "chol", "tri_inv_gram")}
        print(f"precision bench {'/'.join(map(str, PREC_BENCH_SHAPE))} f32 "
              f"{'' if seed == 0 else f'seed {seed} '}"
              f"{lane} {name} ({mode}): {res['solved']}/{PREC_BENCH_SHAPE[2]}"
              f" certified, {res['outer_its']} outer its, "
              f"{res['cum_fac']} factorizations, {res['seconds']:.4f} s; "
              f"K1/K2/K3 launches by mode {json.dumps(modes)}", flush=True)
        if not set(res["statuses"]) <= valid:
            raise RuntimeError(f"precision bench {lane} {name}: statuses "
                               f"{res['statuses']}")
        if lane == "pallas" and not all(
                res["launches"][k] > 0 and modes[k] == {
                    mode: res["launches"][k]} for k in modes):
            raise RuntimeError(f"precision bench {name}: K1-K3 not "
                               f"launched in {mode}: {modes}")
        out[(lane, name)] = res
    print(f"precision TPU invchol records 256/128/16: {PREC_TPU_INVCHOL}",
          flush=True)
    return out


def precision_phase(dev, x_same_f64):
    """Params.matmul_precision on the card: the resolver's table; K1-K3 in
    every mode against their twins; K7 and K5 in every mode timed against
    their IEEE kernels (their twins: `tridiag_mode_phase`, a later phase);
    the mixed phase's float64 "same" run under "high", bit for bit its
    "highest" run (`x_same_f64`); the bench QP under PREC_BENCH beside the
    TPU's records (the certified counts are findings; every run ends with
    valid statuses and, on `pallas`, K1-K3 launched in the run's mode).
    Returns {kernel: {mode: record}}."""
    from onephase_tpu_torch.ops import precision

    t0 = time.perf_counter()
    table = {}
    for name in ("",) + precision.JAX_ENUM:
        try:
            table[name] = str(precision.resolve(name, "cuda"))
        except ValueError:
            table[name] = "ValueError"
    print(f"precision table (cuda): {json.dumps(table)}", flush=True)

    rec = precision_kernel_checks(dev)
    rec.update(tridiag_mode_times(dev))

    # float64 under "high": the knob touches float32 products only
    high, st, _ = bench_run(
        dev, MIXED_SHAPE["n"], MIXED_SHAPE["m"], MIXED_SHAPE["batch"],
        "pallas", extra={"matmul_precision": "high"}, warmup=False,
        require_all=False, base=MIXED_OPTIONS, dtype="float64")
    equal = bool(np.array_equal(st.p.x.cpu().numpy(), x_same_f64))
    print(f"precision f64 high: {high['solved']}/{MIXED_SHAPE['batch']}, "
          f"{high['outer_its']} outer its, {high['cum_fac']} "
          f"factorizations; x bit for bit the \"highest\" run's: {equal}",
          flush=True)
    if not equal:
        raise RuntimeError("precision: a float64 solve under \"high\" "
                           "departs from \"highest\"")

    precision_bench(dev, PREC_BENCH)
    print(f"precision phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return rec


def kkt_lp(seed, n, m):
    """tests/test_dual.py:19-29's feasible LP at (n, m) from `seed`:
    (cvec, A, lcon, ucon, lvar, uvar) as float64 numpy arrays -- a 0.3
    density Gaussian A, ranges b -/+ 1 around b = A x_feas, bounds -/+ 5."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)) * (rng.random((m, n)) < 0.3)
    A[np.all(A == 0.0, axis=1), 0] = 1.0
    b = A @ rng.random(n)
    return (rng.normal(size=n), A, b - 1.0, b + 1.0, np.full(n, -5.0),
            np.full(n, 5.0))


def _counts(name, statuses, outer, fac):
    """Hold a run's statuses and summed outer iterations and
    factorizations to the JAX anchor's (KKT_JAX_ANCHOR); a run of
    KKT_ROUNDOFF to its statuses alone."""
    ref = KKT_JAX_ANCHOR[name]
    print(f"kkt {name}: JAX anchor {ref['statuses'].count('Optimal')}/"
          f"{len(ref['statuses'])} Optimal, {ref['outer_its_sum']} outer "
          f"its, {ref['cum_fac_sum']} factorizations", flush=True)
    if statuses != ref["statuses"]:
        raise RuntimeError(f"kkt {name}: statuses differ from the JAX "
                           f"anchor's: {statuses} vs {ref['statuses']}")
    if name in KKT_ROUNDOFF:
        return
    if (outer, fac) != (ref["outer_its_sum"], ref["cum_fac_sum"]):
        raise RuntimeError(f"kkt {name}: {outer} outer its and {fac} "
                           "factorizations against the JAX anchor's "
                           f"{ref['outer_its_sum']} and {ref['cum_fac_sum']}")


def _profiled_launches(fn) -> int:
    """CUDA kernels one call of `fn` launches, counted by torch.profiler
    (0 where the profiler sees no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if getattr(ev, "device_time_total", 0))


def kkt_lp_pool(dev):
    """The LP pool on both paths, one BatchSolver (B = 1) an LP, float64:
    statuses and objectives agree between the paths; each path's counts
    are held to the JAX anchor.  Returns ({path: summary}, S factor and
    n x n Cholesky ms)."""
    import torch
    from onephase_tpu_torch import ops
    from onephase_tpu_torch.config import Params
    from onephase_tpu_torch.models.lp import LPData
    from onephase_tpu_torch.nlp import canonicalize
    from onephase_tpu_torch.parallel.batch import BatchSolver

    n, m = KKT_LP_SHAPE["n"], KKT_LP_SHAPE["m"]
    seeds = range(KKT_LP_SHAPE["seeds"])
    nlps = [canonicalize(LPData(*kkt_lp(seed, n, m)).to_spec(device=dev),
                         dtype=torch.float64, device=dev) for seed in seeds]
    out = {}
    for path, extra in KKT_LP_PATHS.items():
        pars = Params().with_overrides(dict(KKT_OPTIONS, **extra))
        statuses, objs, outer, fac, syncs, secs = [], [], 0, 0, 0, 0.0
        ops.reset_launch_counts()
        for seed, nlp in zip(seeds, nlps):
            solver = BatchSolver(nlp, pars)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = solver.solve(np.zeros((1, n)))
            torch.cuda.synchronize()
            secs += time.perf_counter() - t0
            statuses += solver.statuses(st)
            objs.append(float(nlp.f(st.p.x)[0]))
            outer += int(st.t[0]) - 1
            fac += int(st.cum_fac[0])
            syncs += solver.kernel.host_syncs
        launches = ops.launch_counts()
        out[path] = {"statuses": statuses, "obj": objs, "outer_its": outer,
                     "cum_fac": fac, "seconds": secs, "host_syncs": syncs,
                     "launches": launches, "kernel": solver.kernel,
                     "state": st}
        print(f"kkt LP pool n={n} m={m} x{len(nlps)} {path}: "
              f"{statuses.count('Optimal')}/{len(nlps)} Optimal, {outer} "
              f"outer its, {fac} factorizations, {secs:.3f} s, host_syncs "
              f"{syncs}, launches {launches}", flush=True)
        _counts(path, statuses, outer, fac)
    dual, prim = out["schur_dual"], out["schur_pallas"]
    if dual["statuses"] != prim["statuses"]:
        raise RuntimeError("kkt LP pool: the paths' statuses differ")
    gaps = [abs(a - b) / abs(b) for a, b in zip(dual["obj"], prim["obj"])]
    print(f"kkt LP pool: objective gap schur_dual vs schur_pallas max "
          f"{max(gaps):.3e} relative, {sum(g <= 1e-7 for g in gaps)}/"
          f"{len(gaps)} within 1e-7 (JAX anchor: max "
          f"{KKT_JAX_ANCHOR['lp_obj_gap_max']:.3e}, "
          f"{KKT_JAX_ANCHOR['lp_obj_gap_within_1e-7']} within 1e-7)",
          flush=True)
    if not max(gaps) <= KKT_LP_OBJ_RTOL:
        raise RuntimeError("kkt LP pool: the paths' objectives disagree")
    for k in ("fused_q", "chol", "tri_inv_gram"):
        if prim["launches"][k] <= 0:
            raise RuntimeError(f"kkt LP pool: schur_pallas launched no {k}")
    # S's factor (m x m, the dual path) against the n x n Cholesky of the
    # same pool's primal factor (K2), at the last LP's final point
    dk, pk = dual["kernel"], prim["kernel"]
    dst, pst = dual["state"], prim["state"]
    dq = dk._fact_q(dk.form_factor(dst.p, dst.cache, dst.fact))
    delta = torch.full((1,), 1e-8, dtype=torch.float64, device=dev)
    pq = pk.form_factor(pst.p, pst.cache, pst.fact).Q
    s_ms, chol_ms = _time_turns(lambda: dk.factor(dq, delta),
                                lambda: pk.factor(pq, delta))
    print(f"kkt LP pool: factor ms a factorization: schur_dual S "
          f"({m}x{m}, formed and factored) {s_ms:.4f}, schur_pallas "
          f"({n}x{n}, K2) {chol_ms:.4f}", flush=True)
    return out, {"s_factor_ms": s_ms, "chol_factor_ms": chol_ms}


def kkt_qp_runs(dev):
    """The symmetric paths on the bench QP (float64, tol 1e-6): every run
    of KKT_QP_RUNS certifies, with the JAX anchor's counts; mr checked
    against the JAX package's; the plain factor's (LDL^T or eigh) median
    ms and its CUDA launches a factorization."""
    import torch
    from onephase_tpu_torch.ops import ldlt as ldlt_mod

    n, m = KKT_QP_SHAPE["n"], KKT_QP_SHAPE["m"]
    out = {}
    for name, (extra, batch) in KKT_QP_RUNS.items():
        lane = extra.get("kkt.linear_solver_type", "xla")
        summary, st, kernel = bench_run(
            dev, n, m, batch, lane, extra=extra, warmup=False,
            require_all=False, base=KKT_OPTIONS, dtype="float64")
        _counts(name, summary["statuses"], summary["outer_its"],
                summary["cum_fac"])
        N = n + kernel.mr
        if kernel.mr != KKT_JAX_ANCHOR[name]["mr"]:
            raise RuntimeError(f"kkt {name}: mr {kernel.mr}, the JAX "
                               f"package's {KKT_JAX_ANCHOR[name]['mr']}")
        fact = kernel.form_factor(st.p, st.cache, st.fact)
        K = fact.Q.clone()
        K.diagonal(dim1=-2, dim2=-1)[:, :n] += 1e-8
        fn = (ldlt_mod.eigh_inertia if lane == "eigh" else ldlt_mod.ldlt)
        ms = _time_ms(lambda: fn(K))
        per_fac = _profiled_launches(lambda: fn(K))
        summary.update({"mr": kernel.mr, "N": N, "factor_ms": ms,
                        "factor_launches": per_fac})
        print(f"kkt {name}: K {N}x{N} (mr {kernel.mr}) B={batch}: "
              f"{'eigh' if lane == 'eigh' else 'LDL^T'} {ms:.4f} ms a "
              f"factorization (median), {per_fac} CUDA launches a "
              "factorization", flush=True)
        out[name] = summary
    return out


def kkt_phase(dev):
    """Every KKT system of the dense driver on the card: the LP pool
    (schur_dual against schur/pallas) and the symmetric paths on the
    bench QP, each count held to the JAX anchor."""
    t0 = time.perf_counter()
    pool, factor_ms = kkt_lp_pool(dev)
    qp = kkt_qp_runs(dev)
    print(f"kkt phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return pool, qp, factor_ms


def _run_kernel(kernel, warmup=False):
    """A kernel's run from its initial state to termination, chunk by
    chunk (after one warm-up chunk from a fresh state with `warmup`: the
    first call of a path's operations pays their CUDA module loads);
    launches are counted from the initial state on, the seconds and host
    syncs over the same span.  Returns (summary, final state)."""
    import torch
    from onephase_tpu_torch import ops
    from onephase_tpu_torch.ipm.state import RUNNING, STATUS_NAMES

    if warmup:
        kernel.run_chunk(kernel.initial_state())
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    kernel.host_syncs = 0
    t0 = time.perf_counter()
    st = kernel.initial_state()
    while int(st.status[0]) == RUNNING:
        st = kernel.run_chunk(st)
    torch.cuda.synchronize()
    return {"status": STATUS_NAMES[int(st.status[0])],
            "outer_its": int(st.t[0]) - 1, "cum_fac": int(st.cum_fac[0]),
            "seconds": time.perf_counter() - t0,
            "host_syncs": kernel.host_syncs,
            "launches": ops.launch_counts()}, st


def _scen_line(key, label, summary):
    """Print a run beside the JAX anchor's `key` and hold its status."""
    ref = SCEN_JAX_ANCHOR[key]
    print(f"scenario {label}: {summary['status']} in {summary['outer_its']} "
          f"outer its, {summary['cum_fac']} factorizations, "
          f"{summary['seconds']:.4f} s, host_syncs {summary['host_syncs']}, "
          f"K2 launches {summary['launches']['chol']}, launches "
          f"{summary['launches']} | JAX anchor "
          f"{ref['status']} in {ref['outer_its']} outer its, "
          f"{ref['cum_fac']} factorizations", flush=True)
    if summary["status"] != ref["status"]:
        raise RuntimeError(f"scenario {label}: {summary['status']}, the "
                           f"JAX anchor's {ref['status']}")


def _arrow_vs_dense(key, name, arrow, x_arrow, dense, x_dense):
    """S2/S3: the arrow and dense runs agree (status, argmin to
    SCEN_X_RTOL, outer iterations within one but on SCEN_ROUNDOFF)."""
    gap = _rel_diff(x_arrow, x_dense)
    held = key not in SCEN_ROUNDOFF
    print(f"scenario {name}: arrow vs dense argmin max rel diff {gap:.3e}, "
          f"outer its {arrow['outer_its']} vs {dense['outer_its']}"
          + ("" if held else " (not held: rounding decides the trajectory)"),
          flush=True)
    if (arrow["status"] != dense["status"]
            or (held and abs(arrow["outer_its"] - dense["outer_its"]) > 1)
            or not gap <= SCEN_X_RTOL):
        raise RuntimeError(f"scenario {name}: the arrow and dense runs "
                           "disagree")


def scenario_chol_shapes(dev):
    """K2 at the scenario path's shapes (SCEN_CHOL_SHAPES) in float32 and
    float64 against its plain version (cholesky_ex, also the library call),
    timed in turns; a non-PD 1 x 1 gives ok = 0.  Returns the records."""
    import torch
    from onephase_tpu_torch.ops import cholesky as ch

    rng = np.random.default_rng(3)
    out = []
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        for B, n in SCEN_CHOL_SHAPES:
            Q = _spd(rng, B, n, dtype, dev)
            L, d, ok = ch.pallas_chol(Q)
            Lr, dr, okr = ch.xla_chol(Q)
            torch.cuda.synchronize()
            if not (bool(ok.all()) and bool(okr.all())):
                raise RuntimeError(f"K2 rejected an SPD matrix (B={B} "
                                   f"n={n})")
            e, ea = _err(L, Lr)
            e = max(e, _err(d, dr)[0])
            ms, lms = _time_turns(lambda: ch.pallas_chol(Q),
                                  lambda: torch.linalg.cholesky_ex(Q))
            el = Q.element_size()
            bd = _bound(el * (2 * B * n * n + B * n) + 4 * B,
                        B * n ** 3 / 3, dname)
            print(f"K2 chol {dname} scenario shape B={B} n={n}: err "
                  f"{e:.3e} kernel {ms:.4f} ms cholesky_ex (plain and "
                  f"library) {lms:.4f} ms ({ms / lms:.2f}x, in turns) bound "
                  f"{bd[0]:.6f} ms ({bd[1]})", flush=True)
            if not e <= TOL[dname]:
                raise RuntimeError(f"K2 disagrees at B={B} n={n}: {e}")
            out.append({"dtype": dname, "B": B, "n": n, "max_abs_err": ea,
                        "ms": ms, "plain_ms": lms, "library_ms": lms,
                        "bound_ms": bd[0], "bound_by": bd[1]})
        Q = -torch.ones(3, 1, 1, dtype=dtype, device=dev)
        if bool(ch.pallas_chol(Q)[2].any()):
            raise RuntimeError("K2 accepted a negative 1 x 1 pivot")
    return out


def scenario_phase(dev):
    """The arrow-KKT path on the card (S1-S4, see SCEN_*).  Every status is
    held to the JAX anchor's; S1 must launch K2 on the pallas lane and no
    kernel on the xla lane; S2 and S3 hold the arrow run to the dense one.
    (K2's times at the path's shapes are `scenario_chol_shapes`', taken
    before the later phases share the card.)  Returns S1's pallas
    summary."""
    import torch
    import onephase_tpu_torch as opt
    from onephase_tpu_torch.config import Params
    from onephase_tpu_torch.ipm.core import OnePhaseKernel
    from onephase_tpu_torch.models import examples, tax
    from onephase_tpu_torch.parallel.scenario import ScenarioKernel

    t_phase = time.perf_counter()

    def pars(base, lane):
        return Params().with_overrides(
            dict(base, **{"kkt.linear_solver_type": lane}))

    # S1: full width, float32, both lanes
    spec = examples.two_stage_qp(**SCEN_S1, device=dev)
    s1, xs = {}, {}
    for lane in ("pallas", "xla"):
        sk = ScenarioKernel(spec, pars(SCEN_S1_OPTIONS, lane),
                            dtype=torch.float32, device=dev)
        s1[lane], st = _run_kernel(sk, warmup=True)
        xs[lane] = st.p.x[0]
        _scen_line("S1", f"S1 two_stage_qp{tuple(SCEN_S1.values())} f32 "
                   f"{lane}", s1[lane])
        if s1[lane]["status"] != "Optimal":
            raise RuntimeError(f"scenario S1 {lane}: {s1[lane]['status']}")
    if s1["pallas"]["launches"]["chol"] <= 0:
        raise RuntimeError("scenario S1: the pallas lane launched no K2")
    if any(s1["xla"]["launches"].values()):
        raise RuntimeError("scenario S1: the xla lane launched a kernel")
    print(f"scenario S1: argmin pallas vs xla max rel diff "
          f"{_rel_diff(xs['pallas'], xs['xla']):.3e}", flush=True)
    del spec, st, sk

    # S2 and S3: the arrow path against the dense path of the flat NLP
    twins = (("S2", f"S2 two_stage_qp{tuple(SCEN_S2.values())} f64",
              examples.two_stage_qp(**SCEN_S2, device=dev), SCEN_OPTIONS),
             ("S3", "S3 tax_grouped(G=64, na_g=8, banded) f64",
              tax.tax_grouped(**SCEN_S3, device=dev), SCEN_S3_OPTIONS))
    for key, name, spec, base in twins:
        p = pars(base, "pallas")
        warm = key == "S2"
        arrow, st = _run_kernel(ScenarioKernel(spec, p, device=dev), warm)
        x_arrow = st.p.x[0]
        _scen_line(key + "_arrow", name + " arrow", arrow)
        nlp = opt.canonicalize(spec.to_nlpspec(), dtype=torch.float64,
                               device=dev)
        dense, st = _run_kernel(OnePhaseKernel(nlp, p), warm)
        _scen_line(key + "_dense", name + " dense", dense)
        _arrow_vs_dense(key, name, arrow, x_arrow, dense, st.p.x[0])
        if arrow["launches"]["chol"] <= 0 or dense["launches"]["chol"] <= 0:
            raise RuntimeError(f"scenario {name}: no K2 launch")
        del spec, nlp, st

    # S4: ECON50 and the examples on the dense path
    mods = {"examples": examples, "tax": tax}
    for name, (mod, fn, args) in SCEN_S4.items():
        nlp = opt.canonicalize(getattr(mods[mod], fn)(*args, device=dev),
                               dtype=torch.float64, device=dev)
        summary, _ = _run_kernel(OnePhaseKernel(
            nlp, pars(SCEN_S4_OPTIONS, "pallas")))
        _scen_line(name, f"S4 {name} f64 dense", summary)
    print(f"scenario phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return s1["pallas"]


def _camp_problems(key):
    from onephase_tpu_torch.models.netlib import mixed_suite, sized_mixed_suite
    if key == "C1":
        return sized_mixed_suite(CAMP_C1["n"], CAMP_C1["m"],
                                 n_pairs=CAMP_C1["n_pairs"],
                                 density=CAMP_C1["density"])
    return mixed_suite(**CAMP_C2)


def _camp_run(dev, key, label, problems, base):
    """One bucketed campaign, float32 with the float64 escalation pass, on
    the card: every instance held to its ground truth (the `_feas` /
    `_infeas` suffix) or, when escalated, to the JAX float64 anchor's
    status; every Optimal feasible member's objective to HiGHS's; the
    escalation kernels on the card.  Returns its summary."""
    import torch
    from onephase_tpu_torch import ops
    from onephase_tpu_torch.config import Params
    from onephase_tpu_torch.parallel import buckets

    pars = Params().with_overrides(base)

    def host_syncs():
        return sum(s.host_syncs for s in buckets.bucket_solvers())

    syncs0 = host_syncs()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = buckets.solve_bucketed(problems, pars, round_to=CAMP_ROUND_TO,
                                 dtype=torch.float32, escalate_f64=True,
                                 device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    syncs = host_syncs() - syncs0
    anchor = CAMP_JAX_ANCHOR[key]
    wrong, misses, escalated, off_anchor, gaps = [], [], [], [], []
    for name, r in sorted(res.items()):
        truth = "Optimal" if name.endswith("_feas") else "primal_infeasible"
        if r.escalated:
            escalated.append(name)
        if r.status != truth:
            misses.append(f"{name}:{r.status}@{r.iterations}it")
            # a certificate of the other class is wrong whatever the pass
            if r.status in ("Optimal", "primal_infeasible") or \
                    not r.escalated:
                wrong.append(name)
        if r.escalated and r.status != anchor[name][0]:
            off_anchor.append(f"{name}:{r.status} (JAX f64 "
                              f"{anchor[name][0]})")
        if r.status == "Optimal" and truth == "Optimal":
            highs = anchor[name][3]
            gaps.append((abs(r.obj - highs) / max(1.0, abs(highs)), name))
    buckets_f64 = [s for s in buckets.bucket_solvers()
                   if s.dtype == torch.float64]
    off_card = [(s.n_pad, s.m_pad) for s in buckets_f64 if s.device != dev]
    n_ok = sum(1 for name, r in res.items() if r.status == (
        "Optimal" if name.endswith("_feas") else "primal_infeasible"))
    worst = max(gaps) if gaps else (0.0, "")
    summary = {
        "label": label, "instances": len(res), "resolved": n_ok,
        "escalated": escalated, "misses": misses, "wall": wall,
        "outer_its": sum(r.iterations for r in res.values()),
        "host_syncs": syncs, "launches": launches,
        "worst_obj_gap": worst[0], "statuses": {
            n: r.status for n, r in res.items()},
        "shape_classes": len(buckets.bucket_shapes(
            [buckets.eliminate_fixed(d)[0] for d in problems.values()],
            CAMP_ROUND_TO))}
    print(f"campaign {label}: {n_ok}/{len(res)} resolved vs ground truth, "
          f"{len(escalated)} escalated to float64 on the card "
          f"{escalated}, {summary['outer_its']} outer its (final passes), "
          f"{summary['shape_classes']} shape classes, {wall:.4f} s, "
          f"host_syncs {syncs}, launches {launches}; objective vs HiGHS "
          f"worst {worst[0]:.3e} ({worst[1]}); misses {misses}",
          flush=True)
    if wrong:
        raise RuntimeError(f"campaign {label}: wrong certificates {wrong}")
    if off_anchor:
        raise RuntimeError(f"campaign {label}: escalated instances off the "
                           f"JAX float64 anchor: {off_anchor}")
    if worst[0] >= CAMP_OBJ_RTOL:
        raise RuntimeError(f"campaign {label}: objective {worst[1]} off "
                           f"HiGHS's by {worst[0]:.3e}")
    if escalated and not buckets_f64:
        raise RuntimeError(f"campaign {label}: no float64 escalation kernel")
    if off_card:
        raise RuntimeError(f"campaign {label}: escalation off the card "
                           f"{off_card}")
    return summary


def campaign_c3(dev):
    """C3: seven small MPS files through harness.run_lp_directory on the
    card (every one certified primal_infeasible), then the CLI twice into
    one output directory (the second call skips every problem)."""
    import io
    import shutil
    import tempfile

    import torch
    from onephase_tpu_torch import cli
    from onephase_tpu_torch.config import Params
    from onephase_tpu_torch.harness import run_lp_directory

    with tempfile.TemporaryDirectory() as tmp:
        mps = Path(tmp) / "mps"
        mps.mkdir()
        for name in CAMP_C3_FILES:
            shutil.copy(ROOT / "results" / "lpi_mps" / f"lpi_{name}.mps",
                        mps / f"lpi_{name}.mps")
        t0 = time.perf_counter()
        summ = run_lp_directory(str(mps), "c3",
                                Params().with_overrides(CAMP_C3_OPTIONS),
                                out_root=str(Path(tmp) / "out"),
                                round_to=CAMP_ROUND_TO, escalate_f64=True,
                                dtype=torch.float32, device=dev)
        wall = time.perf_counter() - t0
        statuses = {k: (v.status, v.it_count) for k, v in summ.items()}
        print(f"campaign C3 run_lp_directory x{len(summ)}: {statuses}, "
              f"{wall:.4f} s", flush=True)
        if len(summ) != len(CAMP_C3_FILES) or any(
                v.status != "primal_infeasible" for v in summ.values()):
            raise RuntimeError(f"campaign C3: not all primal_infeasible: "
                               f"{statuses}")
        argv = ["--problem-set", "netlib_infeasible", "--max-it", "200",
                "--output-level", "0", "--linear-solver", "pallas", "--x64",
                "--output-dir", str(Path(tmp) / "cli"), "--test-name", "c3"]
        outs = []
        for _ in range(2):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                summary = cli.main(argv)
            outs.append((summary, buf.getvalue()))
        (first, out1), (second, out2) = outs
        skipped = out2.count("already solved")
        print(f"campaign C3 cli: {out1.strip().splitlines()[-1]}; second "
              f"call skipped {skipped}/{len(second)}", flush=True)
        bad = {k: v.status for k, v in first.items()
               if v.status in ("ERR", "NaN_ERR")}
        if bad:
            raise RuntimeError(f"campaign C3 cli: {bad}")
        if skipped != len(first) or "RUNNING" in out2:
            raise RuntimeError("campaign C3 cli: the second call re-ran "
                               "problems")
    return {"run_lp_directory": statuses, "wall": wall}


def campaign_phase(dev):
    """The LP campaign path on the card (C1-C3, see CAMP_*): shape-bucketed
    parametric batches, float32 with the float64 escalation pass on the
    card.  Returns C1's pallas summary."""
    t_phase = time.perf_counter()
    c1 = _camp_problems("C1")
    # one pallas run (a warm rerun gave the cold run's counts, PERF.md)
    pal = _camp_run(dev, "C1", "C1 pallas", c1, CAMP_OPTIONS)
    for k in ("fused_q", "chol", "tri_inv_gram"):
        if pal["launches"][k] <= 0:
            raise RuntimeError(f"campaign C1: the pallas lane launched no {k}")
    inv = _camp_run(dev, "C1", "C1 invchol", c1,
                    dict(CAMP_OPTIONS, **{"kkt.linear_solver_type":
                                          "invchol"}))
    if any(inv["launches"].values()):
        raise RuntimeError("campaign C1: the invchol lane launched a kernel")
    same = sum(inv["statuses"][k] == pal["statuses"][k] for k in c1)
    print(f"campaign C1 lanes: pallas and invchol statuses agree on "
          f"{same}/{len(c1)}", flush=True)
    del c1
    c2 = _camp_run(dev, "C2", f"C2 mixed_suite{tuple(CAMP_C2.values())} "
                   "pallas", _camp_problems("C2"), CAMP_C2_OPTIONS)
    c3 = campaign_c3(dev)
    print(f"campaign phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"C1": pal, "C1_invchol": inv, "C2": c2, "C3": c3}


# the mesh phase (parallel/mesh.py, dryrun.py): the sharded paths on two
# ranks that share the card over gloo (NCCL refuses two ranks on one
# device; gloo runs all_reduce and broadcast, the only collectives of the
# port, on CUDA tensors), then the dp leg on a one-rank nccl group.  The
# gloo world runs the dry run (dryrun.rank_dryrun: its four legs to
# termination, the blk leg tax_grouped(G=8 D, na_g=8, "banded") float64
# as the JAX package's dry run runs it), then M1: the mixed phase's
# float64 QP (MIXED_SHAPE, MIXED_OPTIONS, factor "same", `pallas`) sharded 2 x 8 and
# the bench configuration (MESH_BENCH_SHAPE float32, BENCH_OPTIONS)
# sharded 2 x 8; M2: S1 (SCEN_S1 float32, `pallas`) with 128 scenarios a
# rank; M3: the dry run's arrow leg (nz=16, nx=64, K=16, seed 0; K2)
# against the local arrow solve; M4: CHAIN_SHAPE float32 on `xla` with
# MESH_CHAIN_PARTITIONS partitions and the banded BANDED_SMALL_SHAPE
# assembled with MESH_BANDED_PARTITIONS, over the two ranks; M5: M1's
# float64 leg on one nccl rank.  Each run is held to the same run
# unsharded in this process: its counts equal (M1's float64 leg also to
# MESH_M1_ANCHOR, with per-instance iterations equal) and x within
# MESH_X_RTOL; a dp rank's rows also to the same rows solved unsharded at
# the rank's batch (B/D), instance by instance, x within MESH_ROWS_RTOL.
# A library call or a kernel's tile choice on the card may depend on the
# batch, so whether x is equal bit for bit is printed, not demanded, and
# M1's float32 leg is held to its rows only: the float32 bench turns on
# the last bit (ROADMAP R5), and its instances solved at B = 8 certify 13
# of 16.
MESH_WORLD = 2
MESH_TIMEOUT = 600.0
# the phases after the precision phase share the card: the scenario and
# campaign phases each run in a process of its own (`phase_rank`), and the
# mesh phase's ranks start with them, while this process runs the chain,
# banded and kkt phases and the mesh phase's unsharded runs.  Everything
# timed into the kernels line runs before, alone on the card.  Each child
# takes CHILD_THREADS intra-op threads (six processes on the host's
# eight cores); a phase that outlives PHASE_TIMEOUT seconds fails.
CHILD_THREADS = 2
PHASE_TIMEOUT = 900.0
MESH_BENCH_SHAPE = {"n": 256, "m": 128, "batch": 16}
MESH_M1_ANCHOR = {"certified": 16, "outer_its": 207, "cum_fac": 223}
MESH_CHAIN_PARTITIONS = 8
MESH_BANDED_PARTITIONS = 2
# x against the unsharded run's, relative to its largest entry.  S1 and
# the banded run (float32) are held to float32 round-off: a rank's 128
# scenarios, and the banded run's one partition a rank (unbatched), go
# through library calls that round apart from the unsharded batch's
# (1.2e-7 and 2.4e-7, PERF.md); M1's float32 leg is held to its rows
MESH_X_RTOL = {"M1_f64": 1e-12, "M5_f64": 1e-12, "M4_chain": 1e-10,
               "M2_S1": 1e-5, "M4_banded": 1e-5}
MESH_ROWS_RTOL = 1e-12
MESH_ARROW_ATOL = 1e-10
MESH_DENSE = ("M1_f64", "M1_f32")
MESH_STRUCTURED = (("M2_S1", "S1"), ("M4_chain", "chain"),
                   ("M4_banded", "banded"))
_K123 = ("fused_q", "chol", "tri_inv_gram")


def _mesh_axis(mesh, axis):
    import dataclasses
    return None if mesh is None else dataclasses.replace(mesh, axis=axis)


def _dense_figures(st, seconds, launches):
    """A dense batch's final state's figures, per instance, x on the
    host (the mesh phase compares runs by them)."""
    from onephase_tpu_torch.ipm.state import OPTIMAL
    return {"certified": int((st.status == OPTIMAL).sum()),
            "outer_its": int((st.t - 1).sum()),
            "cum_fac": int(st.cum_fac.sum()), "status": st.status.tolist(),
            "t": st.t.tolist(), "fac": st.cum_fac.tolist(),
            "x": st.p.x.cpu().numpy(), "seconds": seconds,
            "launches": launches}


def _mesh_dense(dev, mesh, key, rows=None):
    """M1: the dense QP batch (`key` "f64": MIXED_*, "f32": the bench)
    through ShardedBatchSolver (with `mesh`) or BatchSolver, from
    bench_run's starts (only `rows`, (lo, hi), of them when given),
    launches counted from the init on; the (gathered) final state's
    figures, per instance, with x on the host."""
    import torch
    from onephase_tpu_torch import ops
    from onephase_tpu_torch.config import Params
    from onephase_tpu_torch.models.qp import make_qp
    from onephase_tpu_torch.nlp import canonicalize
    from onephase_tpu_torch.parallel.batch import BatchSolver
    from onephase_tpu_torch.parallel.mesh import ShardedBatchSolver

    shape, base, dtype = ((MIXED_SHAPE, MIXED_OPTIONS, torch.float64)
                          if key == "f64" else
                          (MESH_BENCH_SHAPE, BENCH_OPTIONS, torch.float32))
    n, m, B = shape["n"], shape["m"], shape["batch"]
    pars = Params().with_overrides(
        dict(base, **{"kkt.linear_solver_type": "pallas"}))
    nlp = canonicalize(make_qp(n, m, seed=0, device=dev), dtype=dtype,
                       device=dev)
    solver = (BatchSolver(nlp, pars) if mesh is None else
              ShardedBatchSolver(nlp, pars, mesh=mesh))
    x0s = np.random.default_rng(1).normal(size=(B, nlp.n)) * 0.1
    if rows is not None:
        x0s = x0s[rows[0]:rows[1]]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    st = solver.solve(x0s)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = ops.launch_counts()
    if mesh is not None:
        st = solver.gather(st)
    return _dense_figures(st, dt, launches)


def _mesh_structured(dev, mesh, key):
    """M2 S1 (scenarios over "blk"), M4 chain and banded (partitions over
    "chain") through their kernels, with `mesh` or unsharded; the final
    state's figures (x on the host)."""
    import torch
    from onephase_tpu_torch.config import Params
    from onephase_tpu_torch.models.examples import chain_ocp, two_stage_qp
    from onephase_tpu_torch.nlp import canonicalize
    from onephase_tpu_torch.parallel.banded import BandedKernel
    from onephase_tpu_torch.parallel.chain import ChainKernel
    from onephase_tpu_torch.parallel.scenario import ScenarioKernel

    f32 = torch.float32
    if key == "S1":
        pars = Params().with_overrides(dict(
            SCEN_S1_OPTIONS, **{"kkt.linear_solver_type": "pallas"}))
        kernel = ScenarioKernel(two_stage_qp(**SCEN_S1, device=dev), pars,
                                dtype=f32, device=dev,
                                mesh=_mesh_axis(mesh, "blk"))
    else:
        parts = (MESH_CHAIN_PARTITIONS if key == "chain" else
                 MESH_BANDED_PARTITIONS)
        pars = Params().with_overrides(dict(
            CHAIN_OPTIONS, **{"kkt.linear_solver_type": "xla",
                              "kkt.chain_partitions": parts}))
        if key == "chain":
            kernel = ChainKernel(chain_ocp(**CHAIN_SHAPE, device=dev), pars,
                                 dtype=f32, device=dev,
                                 mesh=_mesh_axis(mesh, "chain"))
        else:
            nlp = canonicalize(chain_ocp(**BANDED_SMALL_SHAPE,
                                         device=dev).to_nlpspec(),
                               dtype=f32, device=dev)
            kernel = BandedKernel(nlp, pars, device=dev,
                                  mesh=_mesh_axis(mesh, "chain"))
    summary, st = _run_kernel(kernel)
    summary["x"] = st.p.x[0].cpu().numpy()
    return summary


def mesh_rank(mesh):
    """One rank of the mesh phase's gloo world: the dry run, M1, M2 S1
    and M4 (and the seconds they took on this rank)."""
    from onephase_tpu_torch import dryrun
    from onephase_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()              # built by the parent; loaded here
    out = {"dryrun": dryrun.rank_dryrun(mesh)}
    out.update({key: _mesh_dense(mesh.device, mesh, key[3:])
                for key in MESH_DENSE})
    for key, kind in MESH_STRUCTURED:
        out[key] = _mesh_structured(mesh.device, mesh, kind)
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh_rank_nccl(mesh):
    """M5: M1's float64 leg on a one-rank nccl group."""
    from onephase_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    out = {"M5_f64": _mesh_dense(mesh.device, mesh, "f64")}
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_rank(mesh, phase):
    """A later phase in a process of its own (a one-rank gloo group on the
    card): `phase(device)`, with float32 products in full float32 as in
    the parent.  Returns its result."""
    import torch
    from onephase_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    return phase(mesh.device)


def phase_start(dev, phase, stack):
    """Start `phase_rank(phase)` beside this process (killed by `stack`,
    an ExitStack, if the script fails first); `.results()[0]` is the
    phase's result."""
    from onephase_tpu_torch.parallel.mesh import SpawnedRanks
    return stack.enter_context(SpawnedRanks(
        phase_rank, 1, "gloo", _card_name(dev), args=(phase,),
        timeout=PHASE_TIMEOUT, threads=CHILD_THREADS))


def _card_name(dev):
    """The ranks' device: this card (a CPU device for a rehearsal)."""
    import torch
    return (f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda"
            else str(dev))


def mesh_start(dev, stack):
    """Start the mesh phase's ranks, which run while this process works
    on: the gloo world (MESH_WORLD ranks, `mesh_rank`) and the one-rank
    nccl group (`mesh_rank_nccl`).  `stack` (an ExitStack) kills them if
    the script fails first.  Returns {"gloo": ranks, "nccl": ranks}."""
    from onephase_tpu_torch.parallel.mesh import SpawnedRanks
    card = _card_name(dev)
    return {"gloo": stack.enter_context(SpawnedRanks(
                mesh_rank, MESH_WORLD, "gloo", card, timeout=MESH_TIMEOUT,
                threads=CHILD_THREADS)),
            "nccl": stack.enter_context(SpawnedRanks(
                mesh_rank_nccl, 1, "nccl", card, timeout=MESH_TIMEOUT,
                threads=CHILD_THREADS))}


def _k123(launches):
    return "/".join(str(launches.get(k, 0)) for k in _K123)


def _x_vs(x, ref):
    """(bit for bit equal, max |x - ref| / max |ref|)."""
    import torch
    x, ref = torch.as_tensor(x), torch.as_tensor(ref)
    return (torch.equal(x, ref),
            float((x - ref).abs().max() / ref.abs().max()))


def _mesh_line(key, ref, ranks, kernels, per_instance=False):
    """Print one leg on every rank beside its unsharded run and hold it:
    its counts (with `per_instance`, every instance's status, iterations
    and factorizations) equal to the unsharded run's, x within
    MESH_X_RTOL[key] where it has one, each of `kernels` launched on
    every rank."""
    keys = ("certified", "outer_its", "cum_fac") if "certified" in ref \
        else ("status", "outer_its", "cum_fac")
    if per_instance:
        keys += ("status", "t", "fac")
    for r, out in enumerate(ranks):
        got = out[key]
        equal, diff = _x_vs(got["x"], ref["x"])
        print(f"mesh {key} rank {r}/{len(ranks)}: "
              + ", ".join(f"{k} {got[k]}" for k in keys[:3])
              + f"; K1/K2/K3 launches {_k123(got['launches'])}; "
              f"{got['seconds']:.4f} s; unsharded "
              + ", ".join(f"{k} {ref[k]}" for k in keys[:3])
              + f", {ref['seconds']:.4f} s; x equal {equal}, max rel diff "
              f"{diff:.3e}", flush=True)
        if any(got[k] != ref[k] for k in keys):
            raise RuntimeError(f"mesh {key} rank {r}: counts differ from "
                               "the unsharded run's")
        if key in MESH_X_RTOL and not diff <= MESH_X_RTOL[key]:
            raise RuntimeError(f"mesh {key} rank {r}: x differs by {diff}")
        for k in kernels:
            if got["launches"][k] <= 0:
                raise RuntimeError(f"mesh {key} rank {r}: no {k} launch")


def _mesh_rows(key, rows_ref, ranks):
    """A dp leg's rows on each rank against the same rows solved
    unsharded at the rank's batch (the same computation): every
    instance's status, iterations and factorizations equal, x within
    MESH_ROWS_RTOL."""
    for r, out in enumerate(ranks):
        got, ref = out[key], rows_ref[r]
        lo, hi = r * len(ref["t"]), (r + 1) * len(ref["t"])
        same = all(got[k][lo:hi] == ref[k] for k in ("status", "t", "fac"))
        equal, diff = _x_vs(got["x"][lo:hi], ref["x"])
        print(f"mesh {key} rank {r}: rows {lo}:{hi} against them solved "
              f"unsharded at B={hi - lo}: per-instance counts equal "
              f"{same}; x equal {equal}, max rel diff {diff:.3e}",
              flush=True)
        if not (same and diff <= MESH_ROWS_RTOL):
            raise RuntimeError(f"mesh {key} rank {r}: its rows differ from "
                               "the unsharded run of those rows")


def mesh_phase(dev, worlds, refs=None):
    """The sharded paths (see MESH_*): the unsharded runs here (M1's whole
    batches from `refs`, {key: _dense_figures}, where earlier phases ran
    them), then the results of `worlds` (`mesh_start`'s): the dry run,
    M1-M4 on MESH_WORLD gloo ranks sharing the card and M5 on a one-rank
    nccl group.  Returns {leg: per-rank launches}."""
    import torch
    from onephase_tpu_torch import dryrun
    from onephase_tpu_torch.ops.block_schur import arrow_factor, arrow_solve

    t_phase = time.perf_counter()
    refs = refs or {}
    ref = {key: refs.get(key) or _mesh_dense(dev, None, key[3:])
           for key in MESH_DENSE}
    B = {"M1_f64": MIXED_SHAPE["batch"], "M1_f32": MESH_BENCH_SHAPE["batch"]}
    rows_ref = {key: [_mesh_dense(dev, None, key[3:], rows=(
        r * B[key] // MESH_WORLD, (r + 1) * B[key] // MESH_WORLD))
        for r in range(MESH_WORLD)] for key in MESH_DENSE}
    for key, kind in MESH_STRUCTURED:
        ref[key] = _mesh_structured(dev, None, kind)
    m1 = ref["M1_f64"]
    if any(m1[k] != v for k, v in MESH_M1_ANCHOR.items()):
        raise RuntimeError(f"mesh M1 unsharded: {m1['certified']}, "
                           f"{m1['outer_its']}, {m1['cum_fac']} against "
                           f"the anchor {MESH_M1_ANCHOR}")
    s1 = SCEN_JAX_ANCHOR["S1"]
    if (ref["M2_S1"]["status"], ref["M2_S1"]["outer_its"],
            ref["M2_S1"]["cum_fac"]) != (s1["status"], s1["outer_its"],
                                         s1["cum_fac"]):
        raise RuntimeError(f"mesh S1 unsharded: {ref['M2_S1']['status']}")
    for key in ("M4_chain", "M4_banded"):
        if ref[key]["status"] != "Optimal":
            raise RuntimeError(f"mesh {key} unsharded: {ref[key]['status']}")

    # the dry run, M1, M2 S1 and M4 on two gloo ranks sharing the card
    ranks = worlds["gloo"].results()
    gloo_s = max(out["seconds"] for out in ranks)
    dry = [out["dryrun"] for out in ranks]
    dryrun.check_dryrun(dry)
    dry_s = max(sum(leg["seconds"] for leg in legs) for legs in dry)
    for r, legs in enumerate(dry):
        for leg in legs:
            print(f"mesh dryrun {leg['leg']} rank {r}/{MESH_WORLD}: "
                  f"{leg.get('statuses', '')} outer its "
                  f"{leg.get('outer_its', '-')}, factorizations "
                  f"{leg.get('factorizations', '-')}; K1/K2/K3 launches "
                  f"{_k123(leg['launches'])}; {leg['seconds']:.4f} s",
                  flush=True)
    # M3: the dry run's arrow leg against the local solve (K2)
    Qzz, Qkk, Bk, rz, rk = dryrun.arrow_blocks(8 * MESH_WORLD)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)[None]

    f = arrow_factor(t(Qzz), t(Qkk), t(Bk),
                     torch.full((1,), 1e-6, dtype=torch.float64,
                                device=dev), use_pallas=True)
    dz, dxk = arrow_solve(f, t(Bk), t(rz), t(rk))
    for r, legs in enumerate(dry):
        arrow = legs[2]
        ddz = float(np.abs(arrow["dz"] - dz.cpu().numpy()).max())
        ddx = float(np.abs(arrow["dxk"] - dxk.cpu().numpy()).max())
        print(f"mesh M3 arrow rank {r}: ok {arrow['ok']}, max |dz - local| "
              f"{ddz:.3e}, max |dxk - local| {ddx:.3e}, equal "
              f"{ddz == 0 and ddx == 0}; K2 launches "
              f"{arrow['launches']['chol']}", flush=True)
        if not (arrow["ok"] and ddz <= MESH_ARROW_ATOL
                and ddx <= MESH_ARROW_ATOL
                and arrow["launches"]["chol"] > 0):
            raise RuntimeError(f"mesh M3 arrow rank {r}: {ddz}, {ddx}")

    _mesh_line("M1_f64", ref["M1_f64"], ranks, _K123, per_instance=True)
    _mesh_rows("M1_f64", rows_ref["M1_f64"], ranks)
    # the float32 bench: its trajectory turns on the last bit (ROADMAP
    # R5), which the rank's batch size may move; printed against the
    # whole batch's run, held to the rank's rows solved at its batch
    f32 = ref["M1_f32"]
    for r, out in enumerate(ranks):
        got = out["M1_f32"]
        equal, diff = _x_vs(got["x"], f32["x"])
        print(f"mesh M1_f32 rank {r}/{MESH_WORLD}: certified "
              f"{got['certified']}, outer its {got['outer_its']}, "
              f"factorizations {got['cum_fac']}; K1/K2/K3 launches "
              f"{_k123(got['launches'])}; {got['seconds']:.4f} s; "
              f"unsharded B={len(f32['t'])}: {f32['certified']}, "
              f"{f32['outer_its']}, {f32['cum_fac']}, {f32['seconds']:.4f} "
              f"s; per-instance iterations equal {got['t'] == f32['t']}; "
              f"x equal {equal}, max rel diff {diff:.3e}", flush=True)
        for k in _K123:
            if got["launches"][k] <= 0:
                raise RuntimeError(f"mesh M1_f32 rank {r}: no {k} launch")
    for r, rr in enumerate(rows_ref["M1_f32"]):
        print(f"mesh M1_f32 rows of rank {r} unsharded at B={len(rr['t'])}: "
              f"certified {rr['certified']}, outer its {rr['outer_its']}, "
              f"factorizations {rr['cum_fac']}", flush=True)
    _mesh_rows("M1_f32", rows_ref["M1_f32"], ranks)
    _mesh_line("M2_S1", ref["M2_S1"], ranks, ("chol",))
    _mesh_line("M4_chain", ref["M4_chain"], ranks, ())
    _mesh_line("M4_banded", ref["M4_banded"], ranks, ())

    # M5: M1's float64 leg over nccl (one rank: NCCL takes one rank a card)
    nccl = worlds["nccl"].results()
    nccl_s = nccl[0]["seconds"]
    _mesh_line("M5_f64", ref["M1_f64"], nccl, _K123, per_instance=True)
    print(f"mesh phase: {time.perf_counter() - t_phase:.1f} s here after "
          f"the ranks' start (gloo ranks {gloo_s:.1f} with the dry run's "
          f"legs {dry_s:.1f}, nccl rank {nccl_s:.1f}, each from its "
          "group's start)", flush=True)
    return {"M1_f64": [out["M1_f64"]["launches"] for out in ranks],
            "M2_S1": [out["M2_S1"]["launches"] for out in ranks],
            "M5_f64": [out["M5_f64"]["launches"] for out in nccl]}


def scenario_then_tridiag_modes(dev):
    """The scenario phase, then K7 and K5 in the matmul modes
    (`tridiag_mode_phase`), in one process: the two together take about
    the campaign phase's time, and a process more on the card would slow
    every other one."""
    return {"scenario": scenario_phase(dev),
            "tridiag_modes": tridiag_mode_phase(dev)}


def later_phases(dev, stack, mixed, mesh_refs):
    """The phases after the precision phase, side by side on the card (see
    CHILD_THREADS): the scenario phase followed by K7 and K5's mode checks
    and the chain runs under the modes, the campaign phase, and the mesh
    phase's ranks start in processes of their own (killed by `stack` if
    the script fails first), then this process runs the chain, banded and
    kkt phases and the mesh phase, and collects the others.  Returns
    {phase: result}."""
    import torch

    # the scenario path: K2 on many small blocks and a border down to 1 x 1;
    # then K7 and K5 in every matmul mode against their twins, and the
    # chain path under CHAIN_MODE_RUNS
    scenario = phase_start(dev, scenario_then_tridiag_modes, stack)
    # the LP campaign path: bucketed parametric batches, K1 on a (B, m, n)
    # Jc, K2 and K3, float64 escalation on the card
    campaign = phase_start(dev, campaign_phase, stack)
    # the multi-device layer: two ranks sharing the card over gloo, one
    # rank over nccl; K1-K3 and K2 launched on every rank
    worlds = mesh_start(dev, stack)

    # the chain path: pallas lane (K5, K7), then the xla lane
    chain, x_chain = chain_run(dev, "pallas")
    chain_xla, x_xla = chain_run(dev, "xla")
    xdiff = float((x_chain - x_xla).abs().max() / x_xla.abs().max())
    print(f"chain argmin: pallas vs xla lane max rel diff {xdiff:.3e}; "
          f"outer its {chain['outer_its']} vs {chain_xla['outer_its']}",
          flush=True)
    if not xdiff < 1e-3:
        raise RuntimeError("the chain lanes' argmins disagree")

    # the banded path: the other consumer of K5 and K7, at nb = 63
    banded = banded_phase(dev, chain, x_chain)
    torch.cuda.synchronize()

    # every KKT system of the dense driver: Schur-dual LPs against the
    # schur/pallas path (K1-K3), the symmetric paths on the bench QP
    kkt_pool = kkt_phase(dev)[0]
    torch.cuda.synchronize()

    mesh_refs["M1_f64"] = mixed["same"]["figures"]
    mesh = mesh_phase(dev, worlds, mesh_refs)
    torch.cuda.synchronize()
    scen = scenario.results()[0]
    chain_modes_line(chain, x_chain, scen["tridiag_modes"]["chain"])
    return {"chain": chain, "banded": banded, "kkt": kkt_pool,
            "mesh": mesh, "scenario": scen["scenario"],
            "campaign": campaign.results()[0],
            "tridiag_modes": scen["tridiag_modes"]}


def chain_modes_line(chain, x_chain, runs):
    """The chain path on `pallas` under each of CHAIN_MODE_RUNS beside its
    IEEE run: status, outer iterations, factorizations, seconds (each
    beside the other later phases), K7/K5 launches, and the argmin's
    distance from the IEEE run's."""
    x_ieee = x_chain.cpu().numpy()

    def fig(s):
        return (f"{s['status']}, {s['outer_its']} outer its, "
                f"{s['cum_fac']} factorizations, {s['seconds']:.4f} s, K7/K5 "
                f"{s['launches']['tridiag_factor']}/"
                f"{s['launches']['tridiag_solve']}")
    parts = [f"\"highest\" (ieee) {fig(chain)}"]
    for name, (s, x) in runs.items():
        d = float(np.abs(x - x_ieee).max() / np.abs(x_ieee).max())
        parts.append(f"\"{name}\" ({s['mode']}) {fig(s)}, argmin max rel "
                     f"diff from ieee's {d:.3e}")
    print(f"chain K={CHAIN_SHAPE['K']} f32 pallas by matmul_precision: "
          + " | ".join(parts), flush=True)


def main() -> int:
    t_start = time.perf_counter()
    if not (ROOT / "onephase_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: onephase_tpu_torch/ not found next to "
                         "this script; run it from a checkout of the repo")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs only "
                         "on the GPU")
    sys.path.insert(0, str(ROOT))
    from onephase_tpu_torch.ops import _build

    dev = torch.device("cuda")
    # the reference multiplies in full float32: no TF32 in any yardstick
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    _build.library()
    print(f"kernel build: {_build.BUILD_SECONDS:.1f} s", flush=True)
    # the clocked copy of K2 for the precision phase's phase split, built
    # meanwhile on the host
    threading.Thread(target=_build.clock_library, daemon=True).start()
    for ln in _ptxas_report(_build.BUILD_LOG, (
            "fused_q_lower_kernel", "fused_q_dmma_kernel",
            "fused_q_wg_kernel", "fused_q_tc_kernel", "chol_kernel",
            "tri_inv_kernel", "tri_inv_mode_kernel", "tridiag_factor_kernel",
            "tridiag_factor_mode_kernel", "tridiag_solve_kernel")):
        print(f"  ptxas: {ln}", flush=True)
    _no_spills(_build.BUILD_LOG)

    record = kernel_parity(dev)
    kernel_routes(dev)
    calls = launch_path(dev)
    for name, key in (("fused_q", "K1"), ("chol", "K2")):
        record[name]["launch_path"] = {
            c: v for c, v in calls.items() if c.startswith(key)}
    k1_per_instance = fused_q_per_instance(dev)
    record["fused_q_tri"] = fused_q_tri_parity(dev)
    record.update(tridiag_parity(dev))
    torch.cuda.synchronize()
    hs071(dev)
    torch.cuda.synchronize()

    # only the argmins are kept: the banded runs' peak memory counts every
    # live tensor
    main_path, st, _ = bench_run(dev, 256, 128, 16, "pallas")
    x_pallas = st.p.x
    # the mesh phase's unsharded M1 float32 batch (MESH_BENCH_SHAPE)
    mesh_refs = {"M1_f32": _dense_figures(st, main_path["seconds"],
                                          main_path["launches"])}
    ref, st, _ = bench_run(dev, 256, 128, 16, "invchol", require_all=False)
    x_invchol = st.p.x
    del st
    # every instance solves the same strictly convex QP from its own start:
    # the certified argmins of both lanes agree to the tolerance's scale
    # (measured spread across instances at tol_opt=1e-4: ~2e-4 relative)
    both = torch.tensor([s == "Optimal" for s in ref["statuses"]],
                        device=dev)
    xdiff = float((x_pallas[both] - x_invchol[both]).abs().max()
                  / x_invchol[both].abs().max())
    spread = float((x_pallas - x_pallas[:1]).abs().max()
                   / x_pallas[0].abs().max())
    print(f"bench argmin: pallas vs invchol lane max rel diff {xdiff:.3e} "
          f"over {int(both.sum())} instances; spread over the pallas "
          f"batch {spread:.3e}", flush=True)
    if not (xdiff < 2e-3 and spread < 2e-3):
        raise RuntimeError("the certified argmins disagree")
    # n=1024: the bench options (fixed 3 refinement passes) leave some f32
    # instances stuck -- the explicit inverse's refinement does not
    # contract at their endgame conditioning (40/64, PERF.md §5; that run
    # left the script for time) -- so certification is required with
    # adaptive refinement (same option tree)
    big, _, _ = bench_run(dev, 1024, 512, 64, "pallas", warmup=False,
                          extra={"kkt.it_refine_adaptive": True})
    torch.cuda.synchronize()

    # the precision knobs: K1-K3 in float32 under float64 solves
    record_mixed = mixed_kernel_times(dev)
    mixed = mixed_phase(dev)
    torch.cuda.synchronize()

    # matmul_precision: K1-K3 in every mode of the card against their
    # twins, float64 under "high", the bench QP under the TPU's pass counts
    record_prec = precision_phase(dev, mixed["same"]["figures"]["x"])
    torch.cuda.synchronize()

    # K2 at the scenario path's shapes, the last times of the kernels line
    scen_chol = scenario_chol_shapes(dev)
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        later = later_phases(dev, stack, mixed, mesh_refs)
    chain, banded, kkt_pool = later["chain"], later["banded"], later["kkt"]
    scen_s1, campaign, mesh = (later["scenario"], later["campaign"],
                               later["mesh"])

    # launches of each kernel on its own path: K1-K3 on the dense bench
    # run, K5 and K7 on the chain run (with those of the banded run
    # beside them); K6 lies on no path and carries its kernel phase's
    launches = {**main_path["launches"],
                **{k: chain["launches"][k]
                   for k in ("tridiag_factor", "tridiag_solve")},
                "fused_q_tri": record["fused_q_tri"].pop("launches")}
    for k in ("tridiag_factor", "tridiag_solve"):
        record[k]["launches_banded"] = banded["launches"][k]
    # K1-K3's times are at n=1024/B=64 (and n=256/B=16): their launches on
    # the 1024/512/64 run beside those of the bench run
    for k in ("fused_q", "chol", "tri_inv_gram"):
        record[k]["launches_n1024"] = big["launches"][k]
        record[k]["launches_f32_run"] = mixed["f32"]["launches"][k]
        record[k]["launches_kkt_lp_pool"] = \
            kkt_pool["schur_pallas"]["launches"][k]
        record[k].update(record_mixed[k])
    # K2 on the scenario path: its launches on S1's pallas run and its
    # times at the scenario shapes
    record["chol"]["launches_scenario_s1"] = scen_s1["launches"]["chol"]
    record["chol"]["scenario_shapes"] = scen_chol
    # K1-K3 on the campaign path: launches on C1's pallas run (K1 on
    # the per-instance Jc, timed alone at its shape)
    for k in ("fused_q", "chol", "tri_inv_gram"):
        record[k]["launches_campaign_c1"] = campaign["C1"]["launches"][k]
    record["fused_q"]["per_instance_jc"] = k1_per_instance
    # K1-K3 in each matmul mode at n=1024 (the precision phase); K7 and K5
    # at the chain's and the banded path's shapes, timed in the precision
    # phase, held to their twins in the later phases, with their launches
    # on the chain runs under CHAIN_MODE_RUNS
    for k in ("tridiag_factor", "tridiag_solve"):
        for mode, extra in later["tridiag_modes"]["records"][k].items():
            record_prec[k][mode].update(extra)
        for s, _ in later["tridiag_modes"]["chain"].values():
            record_prec[k][s["mode"]]["launches"] = s["launches"][k]
    for k in ("fused_q", "chol", "tri_inv_gram", "tridiag_factor",
              "tridiag_solve"):
        record[k]["modes"] = record_prec[k]
    # the mesh phase: launches on every rank (M1 f64 sharded 2 x 8 over
    # gloo and on one nccl rank: K1-K3; S1 with 128 scenarios a rank: K2)
    for k in ("fused_q", "chol", "tri_inv_gram"):
        record[k]["launches_mesh_m1_per_rank"] = [
            r[k] for r in mesh["M1_f64"]]
        record[k]["launches_mesh_m5_nccl"] = mesh["M5_f64"][0][k]
    record["chol"]["launches_mesh_s1_per_rank"] = [
        r["chol"] for r in mesh["M2_S1"]]
    record["fused_q_tri"]["path"] = "none: launches of the kernel phase"
    # K3 is two launches: the inverse (tri_inv.cu), then the Gram product
    # on K1's kernel
    record["tri_inv_gram"]["gram_source"] = \
        "onephase_tpu_torch/csrc/fused_q.cu"
    record["tri_inv_gram"]["mode_source"] = \
        "onephase_tpu_torch/csrc/tri_inv_mode.cuh"
    sources = {
        "fused_q": ("onephase_tpu_torch/csrc/fused_q.cu",
                    "onephase_tpu/ops/schur.py:51"),
        "chol": ("onephase_tpu_torch/csrc/chol.cu",
                 "onephase_tpu/ops/cholesky.py:176"),
        "tri_inv_gram": ("onephase_tpu_torch/csrc/tri_inv.cu",
                         "onephase_tpu/ops/cholesky.py:208"),
        "fused_q_tri": ("onephase_tpu_torch/csrc/fused_q.cu",
                        "onephase_tpu/ops/schur.py:110"),
        "tridiag_solve": ("onephase_tpu_torch/csrc/tridiag.cu",
                          "onephase_tpu/ops/tridiag_pallas.py:194"),
        "tridiag_factor": ("onephase_tpu_torch/csrc/tridiag.cu",
                           "onephase_tpu/ops/tridiag_pallas.py:95"),
    }
    kernels = []
    for name, (src, rep) in sources.items():
        if launches[name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched by its "
                               "path")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
                        **record[name]})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start "
          "to the kernels line", flush=True)
    print(f"card: {_card_line()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
