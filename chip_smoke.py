#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`onephase_tpu_torch`).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from `onephase_tpu_torch/csrc/`, holds
each against its plain PyTorch version on the card, then drives the port's
main path (`NLPSpec -> canonicalize -> OnePhaseKernel (dense Schur) ->
one_phase_solve / BatchSolver`) on the `pallas` lane: HS071 in float64, the
bench configuration (n=256, m=128, batch 16, float32) and the n=1024, m=512,
batch 64 configuration.  Every phase raises on failure, so the script exits
nonzero and never prints the final line; without a CUDA card it refuses to
run.  The last line is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
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
TOL = {"float32": 1e-4, "float64": 1e-10}   # max error / max |reference|
REPS = 20


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


def _time_ms(fn) -> float:
    """Median of REPS launches, each between two CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_parity(dev):
    """K1-K4 against their plain versions, f32 and f64, at the main path's
    shapes, a ragged n, m = 0, n = 2048 and a non-PD Q.  Returns, per
    kernel, (max abs error, kernel ms, plain ms) at the largest main-path
    shape in float32."""
    import torch
    from onephase_tpu_torch.ops import cholesky as ch
    from onephase_tpu_torch.ops import schur

    rng = np.random.default_rng(0)
    record = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        tol = TOL[dname]
        # --- K1 fused_q: (n, m, B, shared Jc/H)
        for n, m, B, shared in ((256, 128, 16, True), (1024, 512, 64, True),
                                (130, 70, 3, False), (64, 0, 2, True)):
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
            if n in (256, 1024):
                ms = _time_ms(lambda: schur.pallas_fused_q(Jc, w, H, bnd))
                pms = _time_ms(lambda: schur.xla_fused_q(Jc, w, H, bnd))
                line += f" kernel {ms:.4f} ms plain {pms:.4f} ms"
                if n == 1024 and dtype == torch.float32:
                    record["fused_q"] = (ea, ms, pms)
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
            M4, d4, ok4 = ch.pallas_chol_inv(Q)
            torch.cuda.synchronize()
            e4 = max(_err(M4, M)[0], _err(d4, d)[0])
            line = (f"K2 chol {dname} n={n} B={B}: err {e2:.3e} | "
                    f"K3 tri_inv_gram err {e3:.3e} | K4 chol_inv err {e4:.3e}")
            if n in (256, 1024):
                t2 = _time_ms(lambda: ch.pallas_chol(Q))
                p2 = _time_ms(lambda: ch.xla_chol(Q))
                t3 = _time_ms(lambda: ch.pallas_tri_inv_gram(L))
                p3 = _time_ms(lambda: ch.xla_chol_inv_from_L(Lr))
                line += (f" | chol {t2:.4f} ms plain {p2:.4f} ms"
                         f" | tri_inv_gram {t3:.4f} ms plain {p3:.4f} ms")
                if n == 1024 and dtype == torch.float32:
                    record["chol"] = (e2a, t2, p2)
                    record["tri_inv_gram"] = (e3a, t3, p3)
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
              require_all=True):
    """bench.py:141-163 on the port: a warm-up chunk, then a timed run of
    fresh states to completion, with the batch driver's float64
    termination recheck between chunks.  Returns (summary, final x)."""
    import torch
    from onephase_tpu_torch import ops
    from onephase_tpu_torch.config import Params
    from onephase_tpu_torch.ipm.state import OPTIMAL, RUNNING
    from onephase_tpu_torch.models.qp import make_qp
    from onephase_tpu_torch.nlp import canonicalize
    from onephase_tpu_torch.parallel.batch import BatchSolver

    options = dict(BENCH_OPTIONS, **(extra or {}))
    options["kkt.linear_solver_type"] = lane
    pars = Params().with_overrides(options)
    nlp = canonicalize(make_qp(n, m, seed=0, device=dev), dtype=torch.float32,
                       device=dev)
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
    print(f"bench n={n} m={m} B={batch} {lane} {extra or ''}: "
          f"{solved}/{batch} Optimal, "
          f"{fac / dt:.2f} fac/s, {solved / dt:.2f} solves/s, {outer} outer "
          f"its, {fac} factorizations, {dt:.4f} s, host_syncs "
          f"{summary['host_syncs']}, launches {launches}", flush=True)
    if require_all and solved != batch:
        raise RuntimeError(f"bench n={n} {lane}: only {solved}/{batch} "
                           f"certified: {summary['statuses']}")
    return summary, st.p.x


def main() -> int:
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
    card = _card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    _build.library()
    print(f"kernel build: {_build.BUILD_SECONDS:.1f} s", flush=True)
    for ln in _build.BUILD_LOG.splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"  ptxas: {ln.strip()}", flush=True)

    record = kernel_parity(dev)
    torch.cuda.synchronize()
    hs071(dev)
    torch.cuda.synchronize()

    main_path, x_pallas = bench_run(dev, 256, 128, 16, "pallas")
    ref, x_invchol = bench_run(dev, 256, 128, 16, "invchol",
                               require_all=False)
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
    bench_run(dev, 1024, 512, 64, "pallas", warmup=False,
              extra={"kkt.it_refine_adaptive": True})
    torch.cuda.synchronize()

    launches = main_path["launches"]
    for name in ("fused_q", "chol", "tri_inv_gram"):
        if launches[name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched by the main "
                               "path")
    sources = {
        "fused_q": ("onephase_tpu_torch/csrc/fused_q.cuh",
                    "onephase_tpu/ops/schur.py:51"),
        "chol": ("onephase_tpu_torch/csrc/chol.cu",
                 "onephase_tpu/ops/cholesky.py:176"),
        "tri_inv_gram": ("onephase_tpu_torch/csrc/tri_inv.cu",
                         "onephase_tpu/ops/cholesky.py:208"),
    }
    kernels = []
    for name, (src, rep) in sources.items():
        err, ms, pms = record[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": pms})
    print(f"card: {_card_line()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
