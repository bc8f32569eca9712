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
  batch 64 configuration (kernels K1-K3);
- the precision knobs on the dense path: the QP at n=1024, m=512, batch
  16 in float64 at tol 1e-6 with adaptive refinement (MIXED_RUNS), with
  the factor in float64, in float32 (K1-K3 launched on float32 operands
  under the float64 solve) and on the fast-f64 lane; then 256/128/16
  float32 on `invchol` under residual_precision="f64" (every certificate
  must pass the float64 termination test) and on `pallas` under
  q_form_dtype="bf16" (no Q kernel launch: the reference's dispatch);
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
  through BatchSolver at tol 1e-6: a pool of 32 LPs (n=1024, m=512,
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
  on the card.  C1: 64 LPs at n=1024, m=512 (one shape class), cold and
  warm, and on `invchol` (no kernel); C2: the 96-instance mixed pool (six
  shape classes); C3: seven MPS files through run_lp_directory, then the
  CLI twice into one directory (the second call skips every problem).
  Every final status must be its ground truth (the `_feas` / `_infeas`
  suffix) or, for an escalated instance, the JAX package's float64 status
  (CAMP_JAX_ANCHOR, tools/jax_campaign_anchor.py); every Optimal
  objective within CAMP_OBJ_RTOL of HiGHS's.  K1 with a per-instance Jc
  is held to its plain version and timed at C1's shape.

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
K5 and K7 kernels are printed first.  Float32 products run without TF32.

Every phase raises on failure, so the script exits nonzero and never prints
the final line; without a CUDA card it refuses to run.  The line before
the last lists every kernel with its launches on its path, its error
against the plain version, its time, the plain version's, a library
call's where one PyTorch call computes the same function, and its bound
(K1-K3 also with their launches on the mixed phase's float32 run, on
the kkt phase's LP pool and on the campaign's C1 run, K1 also with its
per-instance-Jc record; K2 also with its launches on the scenario run and
its times at the scenario shapes).
The last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
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
KKT_LP_SHAPE = {"n": 1024, "m": 512, "seeds": 32}
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
# objective gap between its paths
KKT_JAX_ANCHOR = {
    "schur_dual": {"statuses": ["Optimal"] * 32, "outer_its_sum": 1518,
                   "cum_fac_sum": 2372},
    "schur_pallas": {"statuses": ["Optimal"] * 32, "outer_its_sum": 632,
                     "cum_fac_sum": 664},
    "symmetric": {"statuses": ["Optimal"] * 8, "outer_its_sum": 88,
                  "cum_fac_sum": 96, "mr": 768},
    "clever_symmetric": {"statuses": ["Optimal"] * 8, "outer_its_sum": 88,
                         "cum_fac_sum": 96, "mr": 384},
    "clever_u_and_x": {"statuses": ["Optimal"] * 8, "outer_its_sum": 88,
                       "cum_fac_sum": 96, "mr": 384},
    "symmetric_eigh": {"statuses": ["Optimal"] * 4, "outer_its_sum": 44,
                       "cum_fac_sum": 48, "mr": 768},
    "lp_obj_gap_max": 2.6257086232504837e-07,
    "lp_obj_gap_within_1e-7": 15,
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
# the pallas lane, one shape class of 64 LPs, each with its own A; C2: the
# 96-instance mixed pool of results/mixed_parity_lanes.md with
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
CAMP_C1 = {"n": 1024, "m": 512, "n_pairs": 32, "density": 0.5}
CAMP_C2 = {"n_pairs": 48, "max_n": 600}
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
# FLOP/s outside the tensor cores for each type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
DNAME = {4: "float32", 8: "float64"}    # by element size
# cycles from one FMA's issue to its dependent's (FP32 on Hopper), the unit
# of the block-tridiagonal kernels' dependence bounds
FMA_LATENCY_CYCLES = 4


def _bound(nbytes, flops, dname="float32"):
    """(bound_ms, bound_by): the least time for `nbytes` moved (each input
    read once, each output written once) and `flops` done, the larger of
    bytes over the memory rate and operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
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


def _device_ms(fn, kernel) -> float:
    """Mean device time of the CUDA kernel whose name holds `kernel`, over
    REPS calls of `fn` traced by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key and getattr(ev, "device_time_total", 0):
            total += ev.device_time_total
            count += ev.count
    if not count:
        raise RuntimeError(f"torch.profiler saw no {kernel} on the card")
    return total / count / 1e3


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


def _time_turns(*fns) -> list:
    """Medians of REPS launches of each function, the functions taken in
    turns (f, g, f, g, ...), each launch between two CUDA events: two
    versions compared on one card under the same conditions."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(REPS):
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
    instantiation of the named kernels in the build log."""
    out, current = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            current = next((k for k in kernels if k in ln), None)
            if current:
                # the template arguments of the mangled name: the type,
                # then the integers (tile edge, thread count, ...) and flags
                # where there are any
                args = ln.split(current, 1)[1].split("EEv")[0]
                targs = [{"f": "float", "d": "double"}[args[1]]]
                targs += [v if kind == "i" else ("true" if v == "1" else
                                                 "false")
                          for kind, v in re.findall(r"L([ib])(\d+)E", args)]
                out.append(f"{current}<{', '.join(targs)}>")
        elif current and ("registers" in ln or "spill" in ln):
            out.append("    " + ln.strip().replace("ptxas info    : ", ""))
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
            print(line, flush=True)
            if not (e <= tol and e1 <= tol and sym and tril_k1 and full_k1):
                raise RuntimeError(f"K6 disagrees: {line}")
    record["launches"] = ops.launch_counts()["fused_q_tri"] - before
    return record


def _kv(bound):
    return {"bound_ms": bound[0], "bound_by": bound[1]}


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


def _tridiag_bounds(B, K, nb, el):
    """(K7's bound, K5's bound) at one shape, element size `el`."""
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
    return _bound(b7, f7, DNAME[el]), _bound(b5, f5, DNAME[el])


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


def chain_run(dev, lane):
    """scripts/bench_large.py:54-67 on the port: chain_ocp(K=400, nx=32,
    mc=16) in float32 through ChainKernel on `lane`; one warm-up chunk,
    then a timed run from a fresh state to termination.  Launches are
    counted from the fresh state's init on.  Returns (summary, final x)."""
    import torch
    from onephase_tpu_torch import ops
    from onephase_tpu_torch.config import Params
    from onephase_tpu_torch.ipm.state import RUNNING, STATUS_NAMES
    from onephase_tpu_torch.models.examples import chain_ocp
    from onephase_tpu_torch.parallel.chain import ChainKernel

    pars = Params().with_overrides(
        dict(CHAIN_OPTIONS, **{"kkt.linear_solver_type": lane}))
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
    summary = {
        "lane": lane, "status": STATUS_NAMES[int(st.status[0])],
        "outer_its": int(st.t[0]) - 1, "cum_fac": int(st.cum_fac[0]),
        "obj": float(st.cache.fval[0]), "seconds": dt,
        "host_syncs": ck.host_syncs, "launches": ops.launch_counts()}
    print(f"chain K={CHAIN_SHAPE['K']} nx={CHAIN_SHAPE['nx']} "
          f"mc={CHAIN_SHAPE['mc']} f32 {lane}: {summary['status']} obj "
          f"{summary['obj']:.6f} in {summary['outer_its']} outer its, "
          f"{summary['cum_fac']} factorizations, {dt:.4f} s, host_syncs "
          f"{ck.host_syncs}, launches {summary['launches']}", flush=True)
    if summary["status"] != "Optimal":
        raise RuntimeError(f"chain {lane}: {summary['status']}")
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
              require_all=True, base=None, dtype="float32"):
    """bench.py:141-163 on the port: a warm-up chunk, then a timed run of
    fresh states to completion, with the batch driver's float64
    termination recheck between chunks.  `base` replaces the bench
    options, `dtype` the solve dtype.  Returns (summary, final state,
    kernel)."""
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
    nlp = canonicalize(make_qp(n, m, seed=0, device=dev),
                       dtype=getattr(torch, dtype), device=dev)
    solver = BatchSolver(nlp, pars)
    x0s = np.random.default_rng(1).normal(size=(batch, nlp.n)) * 0.1
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
    solved = int((st.status == OPTIMAL).sum())
    fac = int(st.cum_fac.sum())
    outer = int((st.t - 1).sum())
    summary = {
        "n": n, "m": m, "batch": batch, "lane": lane,
        "solved": solved, "seconds": dt, "fac_per_s": fac / dt,
        "solves_per_s": solved / dt, "outer_its": outer, "cum_fac": fac,
        "host_syncs": solver.kernel.host_syncs, "launches": launches,
        "statuses": solver.statuses(st)}
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
    float32 (the factor_precision="f32" route), each pair in turns, with
    the casts the route adds timed apart.  Returns {kernel: record}."""
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
    rec = {}
    for name, f64_fn, f32_fn, cast_fn, flops in (
            ("fused_q", lambda: schur.pallas_fused_q(Jc, w, H, bnd),
             lambda: schur.pallas_fused_q(*f32),
             lambda: [t.to(torch.float32) for t in (Jc, w, H, bnd)],
             B * m * n * (n + 1)),
            ("chol", lambda: ch.pallas_chol(Q), lambda: ch.pallas_chol(Q32),
             lambda: Q.to(torch.float32), B * n ** 3 / 3),
            ("tri_inv_gram", lambda: ch.pallas_tri_inv_gram(L),
             lambda: ch.pallas_tri_inv_gram(L32),
             lambda: L.to(torch.float32), 2 * B * n ** 3 / 3)):
        ms64, ms32, cast_ms = _time_turns(f64_fn, f32_fn, cast_fn)
        b64 = _bound(0, flops, "float64")[0]
        b32 = _bound(0, flops, "float32")[0]
        print(f"mixed {name} n={n} m={m} B={B}: float64 {ms64:.4f} ms, "
              f"float32 {ms32:.4f} ms (in turns; {ms32 / ms64:.2f}x), cast "
              f"to float32 {cast_ms:.4f} ms; operation bounds {b64:.4f} and "
              f"{b32:.4f} ms", flush=True)
        rec[name] = {"ms_mixed_f64": ms64, "ms_mixed_f32": ms32,
                     "cast_ms_mixed": cast_ms}
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
    Returns (S1's pallas summary, K2's records at the scenario shapes)."""
    import torch
    import onephase_tpu_torch as opt
    from onephase_tpu_torch.config import Params
    from onephase_tpu_torch.ipm.core import OnePhaseKernel
    from onephase_tpu_torch.models import examples, tax
    from onephase_tpu_torch.parallel.scenario import ScenarioKernel

    t_phase = time.perf_counter()
    chol_shapes = scenario_chol_shapes(dev)

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
    return s1["pallas"], chol_shapes


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
    cold = _camp_run(dev, "C1", "C1 pallas cold", c1, CAMP_OPTIONS)
    warm = _camp_run(dev, "C1", "C1 pallas warm", c1, CAMP_OPTIONS)
    for k in ("fused_q", "chol", "tri_inv_gram"):
        if warm["launches"][k] <= 0:
            raise RuntimeError(f"campaign C1: the pallas lane launched no {k}")
    if warm["statuses"] != cold["statuses"]:
        raise RuntimeError("campaign C1: the warm run's statuses differ")
    inv = _camp_run(dev, "C1", "C1 invchol", c1,
                    dict(CAMP_OPTIONS, **{"kkt.linear_solver_type":
                                          "invchol"}))
    if any(inv["launches"].values()):
        raise RuntimeError("campaign C1: the invchol lane launched a kernel")
    same = sum(inv["statuses"][k] == warm["statuses"][k] for k in c1)
    print(f"campaign C1 lanes: pallas and invchol statuses agree on "
          f"{same}/{len(c1)}", flush=True)
    del c1
    c2 = _camp_run(dev, "C2", f"C2 mixed_suite{tuple(CAMP_C2.values())} "
                   "pallas", _camp_problems("C2"), CAMP_C2_OPTIONS)
    c3 = campaign_c3(dev)
    print(f"campaign phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"C1": warm, "C1_cold": cold, "C1_invchol": inv, "C2": c2,
            "C3": c3}


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
    for ln in _ptxas_report(_build.BUILD_LOG, (
            "fused_q_lower_kernel", "chol_kernel", "tri_inv_kernel",
            "tridiag_factor_kernel", "tridiag_solve_kernel")):
        print(f"  ptxas: {ln}", flush=True)

    record = kernel_parity(dev)
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
    # contract at their endgame conditioning -- so they are reported, and
    # certification is required with adaptive refinement (same option tree)
    bench_run(dev, 1024, 512, 64, "pallas", warmup=False, require_all=False)
    big, _, _ = bench_run(dev, 1024, 512, 64, "pallas", warmup=False,
                          extra={"kkt.it_refine_adaptive": True})
    torch.cuda.synchronize()

    # the precision knobs: K1-K3 in float32 under float64 solves
    record_mixed = mixed_kernel_times(dev)
    mixed = mixed_phase(dev)
    torch.cuda.synchronize()

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

    # the scenario path: K2 on many small blocks and a border down to 1 x 1
    scen_s1, scen_chol = scenario_phase(dev)
    torch.cuda.synchronize()

    # the LP campaign path: bucketed parametric batches, K1 on a (B, m, n)
    # Jc, K2 and K3, float64 escalation on the card
    campaign = campaign_phase(dev)
    torch.cuda.synchronize()

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
    # K1-K3 on the campaign path: launches on C1's warm pallas run (K1 on
    # the per-instance Jc, timed alone at its shape)
    for k in ("fused_q", "chol", "tri_inv_gram"):
        record[k]["launches_campaign_c1"] = campaign["C1"]["launches"][k]
    record["fused_q"]["per_instance_jc"] = k1_per_instance
    record["fused_q_tri"]["path"] = "none: launches of the kernel phase"
    # K3 is two launches: the inverse (tri_inv.cu), then the Gram product
    # on K1's kernel
    record["tri_inv_gram"]["gram_source"] = \
        "onephase_tpu_torch/csrc/fused_q.cu"
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
