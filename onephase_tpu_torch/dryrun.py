"""Multi-rank dry run of the port's sharded paths.

The port's counterpart of `__graft_entry__.dryrun_multichip` (the JAX
package's multichip dry run): `dryrun_multichip(world, backend, device)`
spawns `world` ranks (parallel/mesh.spawn_ranks) and runs four legs on
them, each to termination:

1. dp: a multistart batch of tax1d(na=4), one instance per rank, through
   `ShardedBatchSolver` (float64, every instance Optimal);
2. blk: the block-angular ECON model tax_grouped(G=8 D, na_g=8,
   wage_spread="banded") through `ScenarioKernel` with the scenarios
   sharded over the ranks (float64, Optimal);
3. the sharded arrow primitive `sharded_arrow_factor_solve` on K = 8 D
   random scenario blocks (nz=16, nx=64, seed 0) with K2, which must
   factor;
4. chain: chain_ocp(K=4 D, nx=8, mc=3) through `ChainKernel` with its
   D partitions sharded over the ranks (float64, Optimal).

`groups_per_rank` scales leg 2 (8 in the JAX package's dry run).  The
solver legs take the JAX dry run's options, and with them its lane,
`xla`; the arrow primitive factors with K2 (`use_pallas`).  Each rank
returns its statuses, outer iterations, factorizations and its kernel
launches per leg; the parent raises when a leg failed on any rank.
"""

from __future__ import annotations

import time

import numpy as np
import torch

# __graft_entry__.py:36-39's options (its legs run the default `xla` lane)
DRYRUN_OPTIONS = {"output_level": 0, "term.max_it": 81, "chunk_size": 30,
              "history_capacity": 2}


def _launches():
    from . import ops
    return dict(ops.launch_counts())


def _delta(before, after):
    return {k: after[k] - before.get(k, 0) for k in after}


def _leg(name, fn):
    """Run one leg; its seconds and the kernel launches it made."""
    before = _launches()
    t0 = time.perf_counter()
    out = fn()
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = _delta(before, _launches())
    out["leg"] = name
    return out


def leg_dp(mesh):
    from .config import Params
    from .ipm.state import OPTIMAL
    from .models.tax import tax1d
    from .nlp import canonicalize
    from .parallel.mesh import ShardedBatchSolver

    nlp = canonicalize(tax1d(na=4, device=mesh.device), device=mesh.device)
    solver = ShardedBatchSolver(nlp, Params().with_overrides(DRYRUN_OPTIONS),
                                mesh=mesh)
    D = mesh.size
    x0s = np.ones((D, nlp.n)) * (1.0 + 0.05 * np.arange(D))[:, None]
    st = solver.init(x0s)
    for _ in range(4):
        st = solver.run_chunk(st)
        if solver.num_running(st) == 0:
            break
    full = solver.gather(st)
    return {"statuses": solver.statuses(st),
            "ok": bool((full.status == OPTIMAL).all()),
            "outer_its": int((full.t - 1).sum()),
            "factorizations": int(full.cum_fac.sum())}


def _run_kernel(kernel, chunks):
    from .ipm.state import OPTIMAL, STATUS_NAMES
    st = kernel.initial_state()
    for _ in range(chunks):
        st = kernel.run_chunk(st)
        if int(st.status[0]) != 0:            # RUNNING == 0
            break
    return {"statuses": [STATUS_NAMES[int(st.status[0])]],
            "ok": int(st.status[0]) == OPTIMAL,
            "outer_its": int(st.t[0]) - 1,
            "factorizations": int(st.cum_fac[0])}


def leg_blk(mesh, groups_per_rank=8):
    from .config import Params
    from .models.tax import tax_grouped
    from .parallel.mesh import make_mesh
    from .parallel.scenario import ScenarioKernel

    blk = make_mesh(axis="blk", device=mesh.device)
    pars = Params().with_overrides(dict(
        DRYRUN_OPTIONS, **{"term.max_it": 160, "chunk_size": 40}))
    G = groups_per_rank * mesh.size
    sk = ScenarioKernel(tax_grouped(G=G, na_g=8, wage_spread="banded",
                                    device=mesh.device),
                        pars, device=mesh.device, mesh=blk)
    out = _run_kernel(sk, 4)
    out["groups"] = G
    return out


def arrow_blocks(K, nz=16, nx=64, seed=0):
    """The dry run's random arrow system (numpy float64): Qzz (nz, nz),
    Qkk (K, nx, nx), Bk (K, nx, nz), rz (nz,), rk (K, nx)."""
    rng = np.random.default_rng(seed)
    Qzz = rng.normal(size=(nz, nz))
    Qzz = Qzz @ Qzz.T + 2 * np.eye(nz)
    Ms = rng.normal(size=(K, nx, nx))
    Qkk = np.einsum("kij,klj->kil", Ms, Ms) + 2 * np.eye(nx)
    Bk = rng.normal(size=(K, nx, nz)) * (0.3 / np.sqrt(K))
    rz = rng.normal(size=nz)
    rk = rng.normal(size=(K, nx))
    return Qzz, Qkk, Bk, rz, rk


def leg_arrow(mesh, use_pallas=True):
    from .ops.block_schur import sharded_arrow_factor_solve
    from .parallel.mesh import make_mesh

    blk = make_mesh(axis="blk", device=mesh.device)
    K = 8 * mesh.size
    lo, hi = blk.rows(K)
    Qzz, Qkk, Bk, rz, rk = arrow_blocks(K)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64,
                               device=mesh.device)[None]

    dz, dxk, ok = sharded_arrow_factor_solve(
        blk, t(Qzz), t(Qkk[lo:hi]), t(Bk[lo:hi]), 1e-6, t(rz),
        t(rk[lo:hi]), use_pallas=use_pallas)
    return {"ok": bool(ok.all()), "K": K, "dz": dz.cpu().numpy(),
            "dxk": blk.gather(dxk, 1).cpu().numpy()}


def leg_chain(mesh):
    from .config import Params
    from .models.examples import chain_ocp
    from .parallel.chain import ChainKernel
    from .parallel.mesh import make_mesh

    D = mesh.size
    pars = Params().with_overrides(dict(
        DRYRUN_OPTIONS, **{"kkt.chain_partitions": D, "term.max_it": 120,
                       "chunk_size": 40}))
    K = 4 * D
    ck = ChainKernel(chain_ocp(K=K, nx=8, mc=3, device=mesh.device), pars,
                     device=mesh.device,
                     mesh=make_mesh(axis="chain", device=mesh.device))
    out = _run_kernel(ck, 3)
    out["K"] = K
    return out


def rank_dryrun(mesh, groups_per_rank=8):
    """The four legs on one rank (run by `dryrun_multichip`'s ranks)."""
    return [_leg("dp", lambda: leg_dp(mesh)),
            _leg("blk", lambda: leg_blk(mesh, groups_per_rank)),
            _leg("arrow", lambda: leg_arrow(mesh)),
            _leg("chain", lambda: leg_chain(mesh))]


def check_dryrun(results):
    """Raise unless every leg succeeded on every rank, with the same
    replicated figures on each; returns rank 0's legs."""
    for rank, legs in enumerate(results):
        for leg in legs:
            if not leg["ok"]:
                raise RuntimeError(f"dry run leg {leg['leg']} failed on "
                                   f"rank {rank}: "
                                   f"{leg.get('statuses', 'no factor')}")
    keys = ("statuses", "outer_its", "factorizations")
    for legs in results[1:]:
        for a, b in zip(results[0], legs):
            if any(a.get(k) != b.get(k) for k in keys):
                raise RuntimeError(f"dry run leg {a['leg']}: the ranks "
                                   "disagree")
    return results[0]


def dryrun_multichip(world: int, backend: str, device,
                     groups_per_rank: int = 8, timeout: float = 900.0,
                     store_dir=None, threads=None):
    """Spawn `world` ranks over `backend` on `device` (all ranks on it:
    "cuda:0" puts two ranks on one card, which only `gloo` allows), run
    the four legs to termination and return every rank's legs (a list
    per rank); raises when a leg failed."""
    from .parallel.mesh import spawn_ranks
    results = spawn_ranks(rank_dryrun, world, backend, device,
                          args=(groups_per_rank,), timeout=timeout,
                          store_dir=store_dir, threads=threads)
    check_dryrun(results)
    return results
