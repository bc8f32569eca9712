"""Command-line campaign front-end.

Port of onephase_tpu/cli.py (reference: scripts/solve_cutest.jl:16-152 —
ArgParse CLI selecting method, KKT solver, linear solver, tolerance,
output dir, problem sets).  The same parser, flags and problem sets;
`--platform` names the device (`cuda`, the default, or `cpu`) and `--x64`
selects float64 (else float32).

    python -m onephase_tpu_torch.cli --problem-set zoo --kkt-solver schur \\
        --tol 1e-6 --max-it 3000 --output-dir results/run1
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(prog="onephase_tpu_torch",
                                description="one-phase IPM solver on the "
                                            "CUDA card (PyTorch port)")
    p.add_argument("--problem-set", default="zoo",
                   choices=["zoo", "netlib_feasible", "netlib_infeasible",
                            "lpi", "econ", "examples", "mps"],
                   help="which problem family to run")
    p.add_argument("--mps-dir", default=None,
                   help="directory of MPS files (for --problem-set mps)")
    p.add_argument("--method", default="one-phase",
                   choices=["one-phase", "scipy"],
                   help="solver lane (reference: one-phase|ipopt)")
    p.add_argument("--kkt-solver", default="schur",
                   choices=["schur", "symmetric", "clever_symmetric"])
    p.add_argument("--linear-solver", default="xla",
                   choices=["xla", "pallas"])
    p.add_argument("--init", default="gertz", choices=["gertz", "mehrotra"])
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--max-it", type=int, default=3000)
    p.add_argument("--max-time", type=float, default=3600.0)
    p.add_argument("--output-level", type=int, default=1)
    p.add_argument("--output-dir", default="results")
    p.add_argument("--test-name", default="campaign")
    p.add_argument("--dual-ls", type=int, default=1, choices=[0, 1, 2, 3])
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="the device to solve on")
    p.add_argument("--x64", action="store_true", help="enable float64")
    p.add_argument("--compare-csv", default=None,
                   help="reference benchmark-tables CSV for parity report")
    return p


def get_problems(args, device=None):
    if args.problem_set == "zoo":
        from .models import zoo
        names = ["rosenbrook2", "rosenbrook3", "toy_lp1", "toy_lp2",
                 "toy_lp3", "toy_lp5", "toy_lp6", "toy_lp7", "toy_lp8",
                 "toy_lp_inf1", "toy_lp_inf2", "circle1", "circle2",
                 "circle_nc1", "circle_nc2", "circle_nc_inf1", "lp_unbd",
                 "circle_nc_unbd", "unbd_feas"]
        return {n: getattr(zoo, n)() for n in names}
    if args.problem_set == "netlib_feasible":
        from .models import netlib
        return netlib.feasible_suite(device=device)
    if args.problem_set == "netlib_infeasible":
        from .models import netlib
        return netlib.infeasible_suite(device=device)
    if args.problem_set == "lpi":
        from .models import netlib
        return netlib.lpi_suite(max_n=getattr(args, "max_n", 1500),
                                device=device)
    if args.problem_set == "econ":
        from .models.tax import tax1d
        return {f"ECON{na}": tax1d(na=na, device=device)
                for na in (10, 25, 50)}
    if args.problem_set == "examples":
        from .models import examples
        return {"chain50": examples.chain(50, device=device),
                "maxcut20": examples.max_cut(20, 4, device=device),
                "electron12": examples.electron(12, device=device),
                "polygon10": examples.largest_small_polygon(10,
                                                            device=device),
                "kissing6": examples.kissing(6, 3, device=device)}
    if args.problem_set == "mps":
        if not args.mps_dir:
            sys.exit("--mps-dir required for --problem-set mps")
        from .models.netlib import load_netlib
        return load_netlib(args.mps_dir, device=device)
    raise ValueError(args.problem_set)


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from .config import Params
    from .harness import compare_to_reference, run_problems
    from .nlp import canonicalize, resolve_device

    # the card unless the CPU is named (resolve_device raises without one)
    dev = resolve_device(None if args.platform == "cuda" else args.platform)
    dtype = torch.float64 if args.x64 else torch.float32
    pars = Params().with_overrides({
        "term.tol_opt": args.tol,
        "term.max_it": args.max_it,
        "term.max_time": args.max_time,
        "output_level": args.output_level,
        "kkt.kkt_solver_type": args.kkt_solver,
        "kkt.linear_solver_type": args.linear_solver,
        "init.init_style": args.init,
        "ls.dual_ls": args.dual_ls,
    })
    solve_func = None
    if args.method == "scipy":
        from .baselines import scipy_baseline_solve

        def solve_func(spec, p):
            return scipy_baseline_solve(
                canonicalize(spec, dtype=dtype, device=dev), p)

    summary = run_problems(get_problems(args, dev), args.test_name,
                           pars=pars, out_root=args.output_dir,
                           solve_func=solve_func, dtype=dtype, device=dev)
    n_opt = sum(1 for r in summary.values() if r.status == "optimal")
    n_inf = sum(1 for r in summary.values()
                if r.status == "primal_infeasible")
    print(f"\n{len(summary)} problems: {n_opt} optimal, {n_inf} infeasible, "
          f"{len(summary) - n_opt - n_inf} other")
    if args.compare_csv:
        rep = compare_to_reference(summary, args.compare_csv)
        match = sum(1 for v in rep.values() if v["status_match"])
        print(f"status parity vs {args.compare_csv}: {match}/{len(rep)}")
        for k, v in rep.items():
            if not v["status_match"]:
                print(f"  MISMATCH {k}: ours={v['ours_status']} "
                      f"ref={v['ref_status']}")
    return summary


if __name__ == "__main__":
    main()
