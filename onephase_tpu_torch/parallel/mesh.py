"""Process-group meshes and the batch axis sharded over them.

Port of onephase_tpu/parallel/mesh.py on `torch.distributed`, in the SPMD
idiom: one process per rank, each with an explicit device, where the JAX
package has one controller and GSPMD.  A `Mesh` is a process group with
one axis name:

- "dp": data parallel over problem instances (`ShardedBatchSolver`);
- "blk": the scenario axis of the arrow KKT (parallel/scenario.py,
  ops/block_schur.sharded_arrow_factor_solve);
- "chain": the partition axis of the nested-dissection factor
  (parallel/chain.py, parallel/banded.py).

The one collective used is `all_reduce` (with `broadcast`, the only ones
`gloo` runs on CUDA tensors, as two ranks sharing one card need; `nccl`
runs both).  A gather is a zero-padded stacked all-reduce
(`Mesh.gather`): each rank writes its rows of the full stack, zeros
(-0.0 for floats) elsewhere, and the stacks are summed.  Adding -0.0 is
exact, so every rank receives the stack bit for bit; a sum over the
sharded axis is then taken on the gathered stack, in the unsharded code's
order, never as a sum of per-rank partial sums (whose rounding would
differ).

Every decision that gates a collective is taken on values equal on every
rank (replicated values, or flags all-reduced here): a rank that branched
apart would leave the others waiting in a collective.

`SpawnedRanks` / `spawn_ranks` run a function on `world` spawned ranks and
return what each rank returns: the harness of the mesh tests and of the
dry run (onephase_tpu_torch/dryrun.py).
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import Params
from ..ipm.state import STATUS_NAMES, State
from ..nlp import CanonNLP, resolve_device
from .batch import BatchSolver


@dataclass(frozen=True)
class Mesh:
    """One axis of ranks: the process group (None outside any group: a
    one-rank mesh that runs no collective), the axis name, this rank's
    index and the axis size, and the device this rank computes on."""

    group: Any
    axis: str
    rank: int
    size: int
    device: torch.device

    @property
    def shape(self):
        """{axis name: size}, as a JAX mesh's `shape`."""
        return {self.axis: self.size}

    def rows(self, total: int):
        """[lo, hi): this rank's contiguous share of `total` rows."""
        if total % self.size:
            raise ValueError(f"{total} rows not divisible by mesh size "
                             f"{self.size}")
        n = total // self.size
        return self.rank * n, (self.rank + 1) * n

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM):
        """In-place all-reduce over the mesh (none on a groupless mesh; a
        one-rank group still runs it, so its backend is exercised)."""
        if self.group is not None:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def gather(self, local: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The stack of every rank's `local` along `dim`, in rank order, on
        every rank: a zero-padded stacked all-reduce.  Floats are padded
        with -0.0, which leaves every value as it is under IEEE addition
        (+0.0 would turn a -0.0 into +0.0), so the stack is exact bit for
        bit.  Booleans travel as int32 (no backend reduces bool)."""
        if self.group is None:
            return local
        dim = dim % local.dim()
        n = local.shape[dim]
        shape = list(local.shape)
        shape[dim] = n * self.size
        wire = torch.int32 if local.dtype == torch.bool else local.dtype
        pad = -0.0 if wire.is_floating_point else 0
        full = torch.full(shape, pad, dtype=wire, device=local.device)
        full.narrow(dim, self.rank * n, n).copy_(local)
        self.all_reduce(full)
        return full != 0 if local.dtype == torch.bool else full

    def any(self, flag: bool) -> bool:
        """True on every rank when `flag` is True on some rank."""
        if self.group is None:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                         device=self.device)
        self.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def total(self, count: int) -> int:
        """The sum over the ranks of an integer."""
        if self.group is None:
            return int(count)
        t = torch.tensor([int(count)], dtype=torch.int64, device=self.device)
        self.all_reduce(t)
        return int(t.item())


def _same_device(a, b) -> bool:
    """Whether two devices are one ("cuda" is the current card)."""
    def norm(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return norm(a) == norm(b)


def check_mesh_device(mesh: Optional[Mesh], device) -> None:
    """A kernel computes on its mesh's device."""
    if mesh is not None and not _same_device(mesh.device, device):
        raise ValueError(f"the mesh computes on {mesh.device}, the kernel "
                         f"was asked for {device}")


def _default_device(rank: int, device=None) -> torch.device:
    """`device` when given, else the card of this rank (rank modulo the
    card count: ranks beyond the cards share them)."""
    if device is not None:
        return torch.device(device)
    resolve_device(None)          # raises without a card
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              group=None, device=None) -> Optional[Mesh]:
    """A one-axis mesh over `group`, else over the default process group
    (or the sub-group of its first `n_devices` ranks: every rank of the
    default group must make that call, and a rank outside it gets None).
    Outside an initialized process group: a one-rank mesh.  `device`
    defaults to this rank's card."""
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} ranks needs an "
                             "initialized process group (distributed_init)")
        return Mesh(None, axis, 0, 1, _default_device(0, device))
    if group is None:
        world = dist.get_world_size()
        if n_devices is not None and n_devices != world:
            if not 0 < n_devices <= world:
                raise ValueError(f"n_devices={n_devices} outside the "
                                 f"world of {world} ranks")
            group = dist.new_group(ranks=list(range(n_devices)))
            if dist.get_rank() >= n_devices:
                return None
        else:
            group = dist.group.WORLD
    rank = dist.get_rank(group)
    return Mesh(group, axis, rank, dist.get_world_size(group),
                _default_device(dist.get_rank(), device))


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     timeout: Optional[float] = None):
    """Multi-process bring-up through `torch.distributed`; a no-op for one
    process unless it names a store.  `coordinator` is "host:port" (a TCP
    store), or `init_method` any URL `init_process_group` takes (e.g.
    "file:///path"); one process that names either joins a one-rank group
    (a backend's path run on one card).  `backend` is the caller's choice
    and is required: "nccl" where each rank has its own card, "gloo" on
    the CPU or where ranks share a card (NCCL refuses two ranks on one
    device).  `timeout` (seconds) bounds every collective."""
    if ((not num_processes or num_processes <= 1)
            and coordinator is None and init_method is None):
        return
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', not {backend!r}")
    if init_method is None:
        if coordinator is None:
            raise ValueError("distributed_init needs a coordinator "
                             "('host:port') or an init_method")
        init_method = f"tcp://{coordinator}"
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes or 1,
                            rank=process_id or 0, **kw)


def _tree_map(fn, tree):
    """`fn` on every tensor of a state tree (named tuples, tuples, dicts);
    None and other leaves kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_tree_map(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


class ShardedBatchSolver(BatchSolver):
    """BatchSolver whose batch axis is sharded over a mesh ("dp").

    Rank r holds rows [r B/D, (r+1) B/D) of the batch (starting points,
    bound values and parametric data alike) and runs its own batched
    kernel on them: instances never talk to each other, so a chunk needs
    no collective.  The collectives are `num_running` (the sum of the
    ranks' counts), the chunk loop's time-limit flag, and `gather`."""

    def __init__(self, nlp: CanonNLP, pars: Optional[Params] = None,
                 mesh: Optional[Mesh] = None):
        super().__init__(nlp, pars)
        self.mesh = mesh or make_mesh(device=self.kernel.device)
        check_mesh_device(self.mesh, self.kernel.device)

    def init(self, x0s, bvals=None, pdata=None) -> State:
        lo, hi = self._rows(len(x0s))
        if bvals is not None:
            bvals = {k: v[lo:hi] for k, v in bvals.items()}
        if pdata is not None:
            pdata = {k: v[lo:hi] for k, v in pdata.items()}
        return super().init(np.asarray(x0s)[lo:hi], bvals, pdata)

    def num_running(self, st: State) -> int:
        return self.mesh.total(super().num_running(st))

    def _agree(self, flag: bool) -> bool:
        return self.mesh.any(flag)

    def gather(self, st: State) -> State:
        """The full batched State, rows in batch order, on every rank."""
        return _tree_map(lambda t: self.mesh.gather(t, 0), st)

    def shard_state(self, st: State) -> State:
        """This rank's rows of a full batched State (every tensor's
        leading axis): the inverse of `gather`, as a sharded checkpoint
        is resumed (parallel/checkpoint.py)."""
        def rows(t):
            lo, hi = self._rows(t.shape[0])
            return t[lo:hi].clone()
        return _tree_map(rows, st)

    def _rows(self, b: int):
        if b % self.mesh.size:
            raise ValueError(f"batch {b} not divisible by mesh size "
                             f"{self.mesh.size}")
        return self.mesh.rows(b)

    def statuses(self, st: State):
        codes = self.mesh.gather(st.status, 0)
        return [STATUS_NAMES[int(s)] for s in codes.cpu().numpy()]


# ----------------------------------------------------------------------
# spawned ranks
# ----------------------------------------------------------------------
def _rank_main(fn, rank, world, backend, device, init_method, args, out,
               timeout, threads):
    """One spawned rank: join the group, run fn(mesh, *args), report."""
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        distributed_init(num_processes=world, process_id=rank,
                         backend=backend, init_method=init_method,
                         timeout=timeout)
        try:
            result = fn(make_mesh(device=dev), *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


class SpawnedRanks:
    """`fn(mesh, *args)` running on `world` spawned processes joined in one
    process group (`backend` "gloo" or "nccl"; every rank on `device`);
    `results()` waits for the ranks' results, in rank order, while the
    caller may work meanwhile.  Use it as a context manager: leaving it
    kills whatever still runs.

    `fn` and its results are pickled (a module-level function; results on
    the host).  The group meets at a `file://` store in a fresh directory
    under `store_dir` (no port to collide on).  The ranks start with the
    `spawn` method (no fork of a process that holds threads or a CUDA
    context) and, with `threads`, take that many intra-op threads.  A rank
    that raises, dies or outlives `timeout` seconds (which also bounds
    each collective) fails `results()`: every rank is then killed and a
    RuntimeError carries the first failure's traceback.  Never hangs."""

    def __init__(self, fn: Callable, world: int, backend: str, device,
                 args: Sequence = (), timeout: float = 600.0,
                 store_dir: Optional[str] = None,
                 threads: Optional[int] = None):
        import multiprocessing as mp
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend must be 'gloo' or 'nccl', not "
                             f"{backend!r}")
        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self._tmp = tempfile.TemporaryDirectory(dir=store_dir)
        init_method = "file://" + os.path.join(self._tmp.name, "store")
        self._out = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, r, world, backend, str(device), init_method, tuple(args),
            self._out, timeout, threads)) for r in range(world)]
        self._deadline = time.monotonic() + timeout
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self.close()
            raise

    def results(self) -> list:
        results, done = [None] * self.world, 0
        try:
            while done < self.world:
                try:
                    rank, ok, payload = self._out.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(self._procs)
                            if p.exitcode not in (None, 0)
                            and results[r] is None]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} died (exit code "
                            f"{self._procs[dead[0]].exitcode}) without a "
                            "result")
                    if time.monotonic() > self._deadline:
                        raise RuntimeError(
                            f"ranks timed out after {self.timeout:.0f} s "
                            f"({done}/{self.world} reported)")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                results[rank] = payload
                done += 1
            for p in self._procs:
                p.join(timeout=max(1.0, self._deadline - time.monotonic()))
        finally:
            self.close()
        return results

    def close(self):
        for p in self._procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join(timeout=10.0)
        self._out.close()
        self._tmp.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def spawn_ranks(fn: Callable, world: int, backend: str, device,
                args: Sequence = (), timeout: float = 600.0,
                store_dir: Optional[str] = None,
                threads: Optional[int] = None) -> list:
    """`SpawnedRanks(...).results()`: run `fn(mesh, *args)` on `world`
    spawned ranks and return their results in rank order."""
    with SpawnedRanks(fn, world, backend, device, args, timeout, store_dir,
                      threads) as ranks:
        return ranks.results()
