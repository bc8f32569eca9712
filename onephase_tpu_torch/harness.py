"""Benchmark/campaign harness: run problem lists with resume + CSV output.

Port of onephase_tpu/harness.py (reference: benchmark/CUTEst/
run_cutest.jl:106-233): per-problem stdout redirection to log files,
full-history snapshots, incremental resume by skipping problems already in
the summary, a parameter dump per campaign, and CSV tables in the
benchmark-tables format (`name,it,time,fval,con,status`).  The CSV and
JSON files are the JAX package's, byte for byte but for the times.

Every entry point runs on `device` (default: the CUDA card; without one,
pass device="cpu"): `run_problems` canonicalizes each NLPSpec there in
`dtype`, `run_lp_directory` solves its buckets there.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import asdict, dataclass
from typing import Callable, Dict, Optional

import torch

from .config import Params
from .nlp import NLPSpec, canonicalize, resolve_device
from .solver import one_phase_solve
from .utils.timer import Timer

# status name -> benchmark-table status string (reference summary.jl mapping)
TABLE_STATUS = {
    "Optimal": "optimal",
    "primal_infeasible": "primal_infeasible",
    "dual_infeasible": "dual_infeasible",
    "MAX_IT": "MAX_IT",
    "MAX_TIME": "MAX_TIME",
    "MAX_DELTA": "MAX_DELTA",
    "NaN_ERR": "NaN_ERR",
    "ERR": "ERR",
    "STALLED": "MAX_IT",   # no-progress exit; table-equivalent to MAX_IT
}


def _write_json_atomic(path: str, obj) -> None:
    """Write JSON via temp file + rename so concurrent readers (multi-host
    merge scan) never observe a partially-written file."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh, indent=1)
    os.replace(tmp, path)


@dataclass
class ProblemSummary:
    """reference problem_summary2 (benchmark/summary.jl:15-38)."""

    status: str = "ERR"
    it_count: int = -1
    total_time: float = 0.0
    fval: float = float("nan")
    con_vio: float = float("nan")
    dual_feas: float = float("nan")
    comp: float = float("nan")
    number_variables: int = 0
    number_constraints: int = 0


def _default_solve(dtype, device):
    def solve(spec, pars):
        return one_phase_solve(canonicalize(spec, dtype=dtype, device=device),
                               pars)
    return solve


def _trace(profile_dir: str, device, fn):
    """Run `fn` under torch.profiler (the card's kernels too on a CUDA
    device) and write a Chrome trace into `profile_dir`."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        out = fn()
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    return out


def run_problems(problems: Dict[str, NLPSpec], test_name: str,
                 pars: Optional[Params] = None,
                 out_root: str = "results",
                 solve_func: Optional[Callable] = None,
                 profile_dir: Optional[str] = None,
                 dtype=torch.float64,
                 device=None) -> Dict[str, ProblemSummary]:
    """Run a campaign with incremental resume (run_cutest.jl:116-134).

    Each NLPSpec is canonicalized in `dtype` on `device` and solved by
    `one_phase_solve`, unless `solve_func(spec, pars)` is given.
    `profile_dir`: write a `torch.profiler` trace of the whole campaign
    there (`trace.json`, Chrome format): the device's complement of the
    host-side Timer spans.
    """
    dev = resolve_device(device)
    if profile_dir is not None:
        return _trace(profile_dir, dev, lambda: run_problems(
            problems, test_name, pars, out_root, solve_func, None, dtype,
            dev))
    pars = pars or Params()
    out = os.path.join(out_root, test_name)
    os.makedirs(os.path.join(out, "log"), exist_ok=True)
    os.makedirs(os.path.join(out, "hist"), exist_ok=True)

    summary_path = os.path.join(out, "summary.json")
    if os.path.isfile(summary_path):
        with open(summary_path) as fh:
            summary = {k: ProblemSummary(**v) for k, v in json.load(fh).items()}
    else:
        summary = {}
    # write the (possibly empty) summary up front so a host whose shard is
    # empty still produces the file the multi-host merge scan waits for
    _write_json_atomic(summary_path,
                       {k: asdict(v) for k, v in summary.items()})

    with open(os.path.join(out, "par.txt"), "w") as fh:
        pars.write_pars(fh)

    master_timer = Timer()
    solve_func = solve_func or _default_solve(dtype, dev)

    for name, spec in problems.items():
        if name in summary:
            print(f"{name} already solved")
            continue
        print(f"RUNNING {name}")
        rec = ProblemSummary()
        t0 = time.time()
        log_path = os.path.join(out, "log", f"{name}.txt")
        try:
            with open(log_path, "w") as logf, \
                    contextlib.redirect_stdout(logf):
                r = solve_func(spec, pars)
            rec.status = TABLE_STATUS.get(r.status, r.status)
            rec.it_count = r.iterations
            rec.fval = r.obj
            rec.con_vio = r.max_violation
            if r.history:
                rec.dual_feas = r.history[-1]["dual_scaled"]
                rec.comp = r.history[-1]["comp"]
            rec.number_variables = len(r.x)
            rec.number_constraints = len(r.constr_duals)
            if r.timer is not None:
                master_timer = master_timer.merge(r.timer)
            with open(os.path.join(out, "hist", f"{name}.json"), "w") as fh:
                json.dump(r.history, fh)
        except FloatingPointError:
            rec.status = "NaN_ERR"
        except Exception as e:  # noqa: BLE001 — harness must survive anything
            with open(log_path, "a") as logf:
                logf.write(f"\nUncaught error: {type(e).__name__}: {e}\n")
            rec.status = "ERR"
        rec.total_time = time.time() - t0
        summary[name] = rec
        print(f"  it count = {rec.it_count}\n  status = {rec.status}")

        _write_json_atomic(summary_path,
                           {k: asdict(v) for k, v in summary.items()})
        write_csv(os.path.join(out, "summary.csv"), summary)
        with open(os.path.join(out, "timer.txt"), "w") as fh:
            fh.write(master_timer.stats())
    return summary


def _process_identity(process_index, process_count, mesh=None):
    """(index, count): the explicit arguments, else the mesh's rank and
    size, else torch.distributed's rank and world size when a process
    group is up, else (0, 1)."""
    if mesh is not None:
        return (mesh.rank if process_index is None else process_index,
                mesh.size if process_count is None else process_count)
    dist = torch.distributed
    up = dist.is_available() and dist.is_initialized()
    pi = process_index if process_index is not None else (
        dist.get_rank() if up else 0)
    pc = process_count if process_count is not None else (
        dist.get_world_size() if up else 1)
    return pi, pc


def run_problems_multihost(problems: Dict[str, NLPSpec], test_name: str,
                           pars: Optional[Params] = None,
                           out_root: str = "results",
                           solve_func: Optional[Callable] = None,
                           process_index: Optional[int] = None,
                           process_count: Optional[int] = None,
                           dtype=torch.float64, device=None, mesh=None):
    """Multi-host campaign driver (the SLURM-array replacement at the
    process level; reference benchmark/CUTEst/*.sbatch + resume-by-skip,
    run_cutest.jl:116-134).

    Each host solves a round-robin shard of the problem list into
    `<test_name>/host<i>/` on the shared filesystem (per-shard incremental
    resume included), then whichever host observes every shard complete
    merges them into the campaign-level `summary.json`/`summary.csv`.
    Process identity: `process_index`/`process_count`, else the rank and
    size of `mesh` (parallel/mesh.Mesh), else the rank and world size of an
    initialized `torch.distributed` group, else 0 of 1.
    Returns the merged summary, or None while other hosts are still
    running (call again later or let the last-finishing host merge).
    """
    pi, pc = _process_identity(process_index, process_count, mesh)
    names = sorted(problems)
    shard = {n: problems[n] for i, n in enumerate(names) if i % pc == pi}
    run_problems(shard, os.path.join(test_name, f"host{pi}"), pars,
                 out_root, solve_func, dtype=dtype, device=device)

    merged: Dict[str, ProblemSummary] = {}
    for p in range(pc):
        path = os.path.join(out_root, test_name, f"host{p}", "summary.json")
        expected = [n for i, n in enumerate(names) if i % pc == p]
        if not os.path.isfile(path):
            return None
        try:
            with open(path) as fh:
                d = json.load(fh)
        except (json.JSONDecodeError, OSError):
            # another host is mid-write; "still running" per the protocol
            return None
        if not all(n in d for n in expected):
            return None
        merged.update({k: ProblemSummary(**v) for k, v in d.items()})

    out = os.path.join(out_root, test_name)
    os.makedirs(out, exist_ok=True)
    _write_json_atomic(os.path.join(out, "summary.json"),
                       {k: asdict(v) for k, v in merged.items()})
    write_csv(os.path.join(out, "summary.csv"), merged)
    return merged


def run_lp_directory(path: str, test_name: str,
                     pars: Optional[Params] = None,
                     out_root: str = "results",
                     round_to: int = 64,
                     max_batch: int = 256,
                     perturb: float = 0.0,
                     escalate_f64: bool = False,
                     dtype=None, device=None) -> Dict[str, ProblemSummary]:
    """Solve every MPS file under `path` as shape-bucketed batches.

    Instead of one process per LP (the reference's per-problem Netlib
    sweep, benchmark/Netlib/run_netlib.jl), the directory is padded into a
    few shape classes and each class runs as one batch on `device`
    (parallel/buckets.py; `dtype` as there, default float64).
    `perturb > 0` shifts all constraint ranges by -perturb (the
    infeasible-set generator, reference infeas.jl:3-33).
    """
    import glob

    from .models.lp import read_mps_data
    from .parallel.buckets import solve_bucketed

    dev = resolve_device(device)
    pars = pars or Params()
    out = os.path.join(out_root, test_name)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "par.txt"), "w") as fh:
        pars.write_pars(fh)

    problems = {}
    for f in sorted(glob.glob(os.path.join(path, "*"))):
        if not f.lower().endswith((".mps", ".mps.gz", ".sif")):
            continue
        try:
            d = read_mps_data(f)
        except Exception as e:  # noqa: BLE001 — skip unreadable files
            print(f"skipping {f}: {type(e).__name__}: {e}")
            continue
        if perturb:
            d.lcon = d.lcon - perturb
            d.ucon = d.ucon - perturb
        problems[d.name] = d

    t0 = time.time()
    res = solve_bucketed(problems, pars, round_to=round_to,
                         max_batch=max_batch, dtype=dtype,
                         escalate_f64=escalate_f64, device=dev)
    wall = time.time() - t0

    summary = {}
    for name, r in res.items():
        summary[name] = ProblemSummary(
            status=TABLE_STATUS.get(r.status, r.status),
            it_count=r.iterations, total_time=wall / max(1, len(res)),
            fval=r.obj, con_vio=r.max_violation,
            dual_feas=r.dual_feas, comp=r.comp,
            number_variables=len(r.x))
    payload = {k: asdict(v) for k, v in summary.items()}
    # per-problem total_time above is the AMORTIZED share of one batched
    # wall (instances solve concurrently in a bucket — there is no true
    # per-problem wall); the campaign-level truth rides alongside
    payload["_campaign"] = {
        "wall_s": wall, "n_problems": len(res),
        "per_problem_time": "amortized (wall_s / n_problems)"}
    with open(os.path.join(out, "summary.json"), "w") as fh:
        json.dump(payload, fh, indent=1)
    write_csv(os.path.join(out, "summary.csv"), summary)
    print(f"{len(summary)} LPs in {wall:.1f}s "
          f"({len(set((p.n, p.m) for p in problems.values()))} raw shapes)")
    return summary


def write_csv(path: str, summary: Dict[str, ProblemSummary]) -> None:
    """Emit the benchmark-tables CSV format: name,it,time,fval,con,status."""
    with open(path, "w") as fh:
        fh.write("name,it,time,fval,con,status\n")
        for name, rec in summary.items():
            fh.write(f"{name},{rec.it_count},{rec.total_time},"
                     f"{rec.fval},{rec.con_vio},{rec.status}\n")


def compare_to_reference(summary: Dict[str, ProblemSummary],
                         reference_csv: str) -> Dict[str, dict]:
    """Status/iteration parity report against a benchmark-tables CSV."""
    import csv
    ref = {}
    with open(reference_csv) as fh:
        for row in csv.DictReader(fh):
            ref[row["name"].lower()] = row

    def _norm(s):
        # the reference tables mix Julia symbols (":Optimal") and plain
        # strings ("primal_infeasible")
        return s.lstrip(":").lower()

    report = {}
    for name, rec in summary.items():
        r = ref.get(name.lower())
        if r is None:
            continue
        report[name] = {
            "status_match": _norm(rec.status) == _norm(r["status"]),
            "ours_it": rec.it_count, "ref_it": int(r["it"]),
            "ours_status": rec.status, "ref_status": r["status"],
        }
    return report
