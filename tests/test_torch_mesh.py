"""The port's multi-device layer (parallel/mesh.py and the `mesh=` legs of
the chain, banded and scenario kernels, ops/block_schur's sharded arrow
solve) on the CPU: two ranks over `gloo`, spawned by each test that runs
them.

The reference tests held: tests/test_parallel.py (multistart batch, mixed
termination, sharded batch on the mesh, indivisible batch rejected,
batched bound-shift campaign), test_block_schur.py::
test_sharded_matches_local, test_chain.py::
test_chain_sharded_matches_unsharded, test_banded.py::
test_banded_sharded_matches_unsharded and test_scenario.py::
test_scenario_sharded_matches_unsharded / _rejects_indivisible_k.

Every sharded run is held to the port's unsharded run of the same problem
in this process with exact equality (`_equal`: the same bits, NaNs at
the same places) of x, the history (the mu trace), the status, the outer
iterations and the factorizations; the dp legs compare the whole gathered
state.  The unsharded runs are held to the JAX package's unsharded runs
(status, outer iterations, x to 1e-8), and the sharded arrow solve also to
the JAX package's sharded one (to 1e-10) on its 8-device CPU mesh.

The ranks import no JAX: this module imports JAX only inside the fixture
that runs the JAX package.  They meet at a `file://` store in the test's
temporary directory, run one intra-op thread each, and are joined with a
timeout (a failing or hanging rank fails the fixture, never hangs it).
The validation checks need no ranks: a two-rank `Mesh` value (no process
group) is refused before any collective.
"""

import os
import subprocess
import sys
import textwrap
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from onephase_tpu_torch.config import Params
from onephase_tpu_torch.interop import state_from_numpy, state_to_numpy
from onephase_tpu_torch.ipm.state import OPTIMAL
from onephase_tpu_torch.models import zoo
from onephase_tpu_torch.models.examples import chain_ocp, two_stage_qp
from onephase_tpu_torch.models.netlib import feasible_suite
from onephase_tpu_torch.models.tax import tax1d
from onephase_tpu_torch.nlp import canonicalize
from onephase_tpu_torch.ops.block_schur import (arrow_factor, arrow_solve,
                                                sharded_arrow_factor_solve)
from onephase_tpu_torch.parallel.banded import BandedKernel
from onephase_tpu_torch.parallel.batch import BatchSolver
from onephase_tpu_torch.parallel.chain import ChainKernel
from onephase_tpu_torch.parallel.mesh import (Mesh, ShardedBatchSolver,
                                              SpawnedRanks,
                                              distributed_init, make_mesh)
from onephase_tpu_torch.parallel.scenario import ScenarioKernel

WORLD = 2
CPU = torch.device("cpu")
# the port's runs keep the whole mu trace (the history is a record only)
TRACE = {"history_capacity": 200}
DP_OPTS = {"output_level": 0, "term.max_it": 81, "chunk_size": 30,
           "history_capacity": 2}                # tests/test_parallel.py
STRUCT_OPTS = {"output_level": 0, "term.max_it": 100, "chunk_size": 100,
               "history_capacity": 2}            # test_chain/_banded/_scenario
SHIFTS = (0.0, 25.0, 30.0, 35.0)   # the reference's three, and a fourth
RANK_TIMEOUT = 240.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as the ranks run (and an order of magnitude
    faster for these small tensors beside the other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pars(base, **over):
    return Params().with_overrides(dict(base, **over))


# ----------------------------------------------------------------------
# the problems (both packages build them from the same numpy data)
def _dp_case(name, device=CPU):
    """(nlp, x0s, bvals) of a dp leg."""
    if name == "multistart":
        nlp = canonicalize(zoo.starting_point_prob(0.5), device=device)
        return nlp, np.array([[0.5], [-0.5], [0.9], [-0.9]]), None
    if name == "mixed":
        nlp = canonicalize(zoo.circle_nc2(), device=device)
        return nlp, np.array([[1.0, 1.0], [0.3, 2.0], [-1.5, 0.2],
                              [2.0, -2.0]]), None
    if name == "tax1d":
        nlp = canonicalize(tax1d(na=4, device=device), device=device)
        return nlp, np.ones((4, nlp.n)) * (1.0 + 0.05 * np.arange(4))[
            :, None], None
    nlp = canonicalize(feasible_suite(sizes=((12, 16),), device=device)[
        "afiro_like"], device=device)
    return nlp, np.tile(nlp.x0, (len(SHIFTS), 1)), nlp.shifted_bvals(
        torch.tensor(SHIFTS, dtype=torch.float64))


DP_LEGS = ("multistart", "mixed", "tax1d", "shift")


def _dp_pars(name):
    if name == "shift":
        return _pars(DP_OPTS, **{"term.max_it": 200, "chunk_size": 50,
                                 **TRACE})
    return _pars(DP_OPTS, **TRACE)


def _arrow_data(K=8, nx=6, nz=4, seed=0):
    """tests/test_block_schur.py:make_arrow."""
    rng = np.random.default_rng(seed)
    Qzz = rng.normal(size=(nz, nz))
    Qzz = Qzz @ Qzz.T + 2 * np.eye(nz)
    Qkk = np.zeros((K, nx, nx))
    Bk = rng.normal(size=(K, nx, nz)) * 0.3
    for k in range(K):
        M = rng.normal(size=(nx, nx))
        Qkk[k] = M @ M.T + 2 * np.eye(nx)
    return Qzz, Qkk, Bk, rng.normal(size=nz), rng.normal(size=(K, nx))


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)[None]


def _structured(name, lane, mesh=None):
    """A structured kernel of the chain, banded or scenario leg (the mesh
    gets the leg's axis name)."""
    def axis(a):
        return None if mesh is None else replace(mesh, axis=a)
    if name == "scenario":
        return ScenarioKernel(
            two_stage_qp(K=8, device=CPU),
            _pars(STRUCT_OPTS, **TRACE, **{"kkt.linear_solver_type": lane}),
            device=CPU, mesh=axis("blk"))
    pars = _pars(STRUCT_OPTS, **TRACE, **{"kkt.linear_solver_type": lane,
                                          "kkt.chain_partitions": 8})
    spec = chain_ocp(K=16, nx=6, mc=3, device=CPU)
    if name == "chain":
        return ChainKernel(spec, pars, device=CPU, mesh=axis("chain"))
    return BandedKernel(canonicalize(spec.to_nlpspec(), device=CPU), pars,
                        device=CPU, mesh=axis("chain"))


STRUCT_LEGS = (("chain", "xla"), ("banded", "xla"), ("scenario", "xla"),
               ("scenario", "pallas"))


def _replicated(st):
    """The replicated fields of a structured kernel's state (its factor
    holds this rank's blocks)."""
    return state_to_numpy({"x": st.p.x, "y": st.p.y, "s": st.p.s,
                           "mu": st.p.mu, "hist": st.hist.buf,
                           "status": st.status, "t": st.t,
                           "cum_fac": st.cum_fac, "delta": st.delta})


def _dp_run(name, mesh=None, start=None):
    """A dp leg's final state (gathered), through ShardedBatchSolver with a
    mesh, else BatchSolver; `start` (a JAX batched state, numpy leaves)
    replaces the solver's own initial state."""
    nlp, x0s, bvals = _dp_case(name)
    pars = _dp_pars(name)
    if mesh is None:
        solver = BatchSolver(nlp, pars)
    else:
        solver = ShardedBatchSolver(nlp, pars, mesh=mesh)
    if start is None and name != "tax1d":
        st = solver.solve(x0s, bvals)
    else:
        # test_sharded_batch_runs_on_mesh's loop: chunks until none runs
        st = (solver.init(x0s, bvals) if start is None else
              state_from_numpy(start, device=CPU, mesh=mesh))
        for _ in range(20):
            if solver.num_running(st) == 0:
                break
            st = solver.run_chunk(st)
    rows = st.p.x.shape[0]
    if mesh is not None:
        st = solver.gather(st)
    return state_to_numpy(st), rows


def _rank_dp(mesh, name, start=None):
    """A dp leg on one rank (and, with `start`, the same leg from that
    carried state)."""
    out = {"run": _dp_run(name, mesh)}
    if start is not None:
        out["carried"] = _dp_run(name, mesh, start=start)
    return out


# the checkpoint leg: the mixed leg in chunks of 3 outer iterations,
# saved after 2 (one instance done, three running)
RESUME_OPTS = dict(DP_OPTS, chunk_size=3)
RESUME_CHUNKS = 2


def _chunks(solver, st, limit=None):
    """run_chunk until no instance runs (or `limit` chunks)."""
    n = 0
    while solver.num_running(st) and (limit is None or n < limit):
        st, n = solver.run_chunk(st), n + 1
    return st


def _rank_resume(mesh, ckpt_dir):
    """The checkpoint leg on one rank: run through, and run RESUME_CHUNKS
    chunks, gather, save, load, `shard_state` and run on; both gathered
    (numpy), and the instances still running at the checkpoint."""
    from onephase_tpu_torch.parallel.checkpoint import load_state, save_state
    nlp, x0s, _ = _dp_case("mixed")
    solver = ShardedBatchSolver(nlp, _pars(RESUME_OPTS, **TRACE), mesh=mesh)
    whole = solver.gather(_chunks(solver, solver.init(x0s)))
    full = solver.gather(_chunks(solver, solver.init(x0s), RESUME_CHUNKS))
    path = os.path.join(ckpt_dir, f"rank{mesh.rank}.npz")
    save_state(path, full)
    st = solver.shard_state(load_state(path, full))
    resumed = solver.gather(_chunks(solver, st))
    return (state_to_numpy(whole), state_to_numpy(resumed),
            int((full.status == 0).sum()))


def _rank_arrow(mesh):
    """The sharded arrow solve on both lanes, and the exactness of the
    gather (signed zeros, infinities, NaN, a subnormal)."""
    Qzz, Qkk, Bk, rz, rk = _arrow_data()
    blk = replace(mesh, axis="blk")
    lo, hi = blk.rows(Qkk.shape[0])
    out = {}
    for pallas in (False, True):
        out[pallas] = state_to_numpy(sharded_arrow_factor_solve(
            blk, _t(Qzz), _t(Qkk[lo:hi]), _t(Bk[lo:hi]), 1e-3, _t(rz),
            _t(rk[lo:hi]), use_pallas=pallas))
    v = torch.tensor([[-0.0, np.inf, -np.inf, np.nan, 1e-310, -3.5]],
                     dtype=torch.float64) * (mesh.rank + 1)
    out["gather"] = mesh.gather(v, 0).numpy()
    return out


def _rank_structured(mesh, name, lane):
    k = _structured(name, lane, mesh)
    return _replicated(k.run_chunk(k.initial_state()))


def _ranks(tmp_path, fn, *args):
    """`fn(mesh, *args)` on WORLD gloo ranks on the CPU, started now;
    `.results()` joins them (with a timeout)."""
    return SpawnedRanks(fn, WORLD, "gloo", CPU, args=args,
                        timeout=RANK_TIMEOUT, store_dir=str(tmp_path),
                        threads=1)


def _equal(a, b):
    """Exactly equal trees of numpy arrays (NaNs at the same places)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif a is None:
        assert b is None
    else:
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


# ----------------------------------------------------------------------
# the JAX package's runs (imported here only: the ranks import no JAX)
def _np_tree(st):
    import jax
    return jax.tree_util.tree_map(np.asarray, st)


def _jax_dp(name):
    """The JAX BatchSolver's run of a dp leg: (initial state as the port's
    State of numpy leaves, final state, bvals), numpy."""
    import jax
    import jax.numpy as jnp
    from onephase_tpu.config import Params as JParams
    from onephase_tpu.models import zoo as jzoo
    from onephase_tpu.models.netlib import feasible_suite as jfeas
    from onephase_tpu.models.tax import tax1d as jtax1d
    from onephase_tpu.nlp import canonicalize as jcanon
    from onephase_tpu.parallel.batch import BatchSolver as JBatch

    spec = {"multistart": lambda: jzoo.starting_point_prob(0.5),
            "mixed": jzoo.circle_nc2, "tax1d": lambda: jtax1d(na=4),
            "shift": lambda: jfeas(sizes=((12, 16),))["afiro_like"]}[name]()
    nlp = jcanon(spec)
    _, x0s, _ = _dp_case(name)
    opts, bvals = dict(DP_OPTS), None
    if name == "shift":
        opts.update({"term.max_it": 200, "chunk_size": 50})
        bvals = jax.vmap(nlp.shifted_bvals)(jnp.asarray(SHIFTS))
    solver = JBatch(nlp, JParams().with_overrides(opts))
    st = solver.init(x0s, bvals)
    # as the port's State of numpy leaves: the ranks unpickle it without
    # importing the JAX package
    start = state_to_numpy(state_from_numpy(_np_tree(st), device=CPU))
    for _ in range(100):
        if not bool(jnp.any(st.status == 0)):
            break
        st = solver.run_chunk(st)
    return start, _np_tree(st), None if bvals is None else _np_tree(bvals)


def _jax_resume(ckpt_dir):
    """The JAX package's checkpoint leg: its ShardedBatchSolver on two CPU
    devices runs RESUME_CHUNKS chunks, saves, loads, `shard_state`s and
    runs on (numpy)."""
    import jax.numpy as jnp
    from onephase_tpu.config import Params as JParams
    from onephase_tpu.models import zoo as jzoo
    from onephase_tpu.nlp import canonicalize as jcanon
    from onephase_tpu.parallel.checkpoint import load_state, save_state
    from onephase_tpu.parallel.mesh import ShardedBatchSolver as JSharded
    from onephase_tpu.parallel.mesh import make_mesh as jmesh
    _, x0s, _ = _dp_case("mixed")
    solver = JSharded(jcanon(jzoo.circle_nc2()),
                      JParams().with_overrides(RESUME_OPTS), mesh=jmesh(2))
    st = solver.init(x0s)
    for _ in range(RESUME_CHUNKS):
        st = solver.run_chunk(st)
    path = os.path.join(ckpt_dir, "jax.npz")
    save_state(path, st)
    st = solver.shard_state(load_state(path, st))
    for _ in range(100):
        if not bool(jnp.any(st.status == 0)):
            break
        st = solver.run_chunk(st)
    return _np_tree(st)


def _jax_structured(name):
    """The JAX package's unsharded chain (P = 8), banded (P = 8) or
    scenario (K = 8) run, numpy."""
    from onephase_tpu.config import Params as JParams
    from onephase_tpu.models.examples import chain_ocp as jchain
    from onephase_tpu.models.examples import two_stage_qp as jts
    from onephase_tpu.nlp import canonicalize as jcanon
    from onephase_tpu.parallel.banded import BandedKernel as JBanded
    from onephase_tpu.parallel.chain import ChainKernel as JChain
    from onephase_tpu.parallel.scenario import ScenarioKernel as JScen

    pars = JParams().with_overrides(STRUCT_OPTS)
    pars8 = pars.with_overrides({"kkt.chain_partitions": 8})
    if name == "chain":
        k = JChain(jchain(K=16, nx=6, mc=3), pars8)
    elif name == "banded":
        k = JBanded(jcanon(jchain(K=16, nx=6, mc=3).to_nlpspec()), pars8)
    else:
        k = JScen(jts(K=8), pars)
    return _np_tree(k.run_chunk(k.initial_state()))


def _jax_sharded_arrow():
    """The JAX package's sharded arrow solve on its 8-device CPU mesh."""
    import jax.numpy as jnp
    from onephase_tpu.ops.block_schur import sharded_arrow_factor_solve
    from onephase_tpu.parallel.mesh import make_mesh as jmesh
    Qzz, Qkk, Bk, rz, rk = _arrow_data()
    return [np.asarray(a) for a in sharded_arrow_factor_solve(
        jmesh(8, axis="blk"), jnp.asarray(Qzz), jnp.asarray(Qkk),
        jnp.asarray(Bk), 1e-3, jnp.asarray(rz), jnp.asarray(rk))]


def _held_to_jax(st, jst, x_tol=1e-8):
    """status, outer iterations and x of a port state (numpy, batched) and
    a JAX one (numpy, batched or not)."""
    get = st.get if isinstance(st, dict) else None
    status = get("status") if get else st.status
    t = get("t") if get else st.t
    x = get("x") if get else st.p.x
    np.testing.assert_array_equal(status, np.atleast_1d(jst.status))
    np.testing.assert_array_equal(t, np.atleast_1d(jst.t))
    np.testing.assert_allclose(x, np.atleast_2d(jst.p.x), rtol=0,
                               atol=x_tol)


def _dp_leg(tmp_path, name, carry=False, exact=True):
    """Run a dp leg on the ranks, unsharded here and in the JAX package
    (meanwhile, unless its initial state is carried to the ranks); hold
    every rank's gathered state to the unsharded run's, leaf for leaf (not
    `exact`: equal counts, x and mu to 1e-12), each rank to B/D rows, and
    the unsharded run to the JAX package's.  Returns the unsharded final
    state, the ranks' results and the JAX run (start, end, bvals)."""
    jax_run = _jax_dp(name) if carry else None
    start = jax_run[0] if carry else None
    with _ranks(tmp_path, _rank_dp, name, start) as ranks:
        if jax_run is None:
            jax_run = _jax_dp(name)
        full, _ = _dp_run(name)
        outs = ranks.results()
    for out in outs:
        st, rows = out["run"]
        assert rows == len(full.status) // WORLD
        if exact:
            _equal(st, full)
            continue
        for k in ("status", "t", "cum_fac", "tot_num_fac"):
            np.testing.assert_array_equal(getattr(st, k), getattr(full, k))
        np.testing.assert_allclose(st.p.x, full.p.x, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(st.p.mu, full.p.mu, rtol=1e-12,
                                   atol=1e-12)
    _held_to_jax(full, jax_run[1])
    return full, outs, jax_run


# ----------------------------------------------------------------------
# tests/test_parallel.py
def test_batch_multistart_matches_single(tmp_path):
    """Also carries the JAX package's initial batched state into the ranks
    (interop.state_from_numpy(mesh=): each rank's rows) and gathers it
    back: equal to the unsharded port's run from that state, and at the
    JAX package's end."""
    full, outs, (start, jend, _) = _dp_leg(tmp_path, "multistart",
                                           carry=True)
    assert (full.status == OPTIMAL).all()
    # every start converges to one of the two local optima |x| = 1
    assert np.all(np.abs(np.abs(full.p.x[:, 0]) - 1.0) < 1e-3)
    carried, _ = _dp_run("multistart", start=start)
    for out in outs:
        _equal(out["carried"][0], carried)
    _held_to_jax(carried, jend)


def test_batch_mixed_termination(tmp_path):
    full = _dp_leg(tmp_path, "mixed")[0]
    assert (full.status == OPTIMAL).all()
    assert full.t.min() >= 2
    assert len(set(full.t.tolist())) > 1     # they finish apart


def test_sharded_batch_runs_on_mesh(tmp_path):
    """tax1d(na=4), B = 4 over 2 ranks: 2 rows a rank, all Optimal."""
    full, outs, _ = _dp_leg(tmp_path, "tax1d")
    assert (full.status == OPTIMAL).all()
    assert [out["run"][1] for out in outs] == [2, 2]


def test_sharded_indivisible_batch_rejected():
    nlp = canonicalize(zoo.toy_lp1(), device=CPU)
    two = Mesh(None, "dp", 0, WORLD, CPU)
    solver = ShardedBatchSolver(nlp, _pars(DP_OPTS), mesh=two)
    with pytest.raises(ValueError, match="not divisible"):
        solver.init(np.zeros((5, nlp.n)))


def test_sharded_checkpoint_resumes(tmp_path):
    """ShardedBatchSolver.shard_state, the resume half of a sharded
    checkpoint (onephase_tpu/parallel/checkpoint.py:10-11): on two ranks
    of one world the mixed leg runs RESUME_CHUNKS chunks, is gathered,
    saved, loaded, re-sharded and run on to the end, which equals the
    uninterrupted sharded run's bit for bit (the whole gathered state) and
    the JAX package's save/load/shard_state run of the same batch (run
    meanwhile) in status, outer iterations and x (1e-8)."""
    with _ranks(tmp_path, _rank_resume, str(tmp_path)) as ranks:
        jend = _jax_resume(str(tmp_path))
        outs = ranks.results()
    for whole, resumed, running in outs:
        assert running == 3
        _equal(resumed, whole)
    _held_to_jax(outs[0][1], jend)


def test_shard_state_takes_each_ranks_rows():
    """shard_state slices every tensor's leading axis to the rank's rows
    (`Mesh.rows`), as `init` slices the starts, and refuses a batch the
    mesh does not divide; two-rank Mesh values, no process group."""
    nlp, x0s, _ = _dp_case("mixed")
    full = BatchSolver(nlp, _pars(DP_OPTS)).init(x0s)
    want = state_to_numpy(full)
    for rank in range(WORLD):
        mesh = Mesh(None, "dp", rank, WORLD, CPU)
        solver = ShardedBatchSolver(nlp, _pars(DP_OPTS), mesh=mesh)
        got = state_to_numpy(solver.shard_state(full))
        rows = slice(2 * rank, 2 * rank + 2)
        _equal(got, _slice_rows(want, rows))
        odd = BatchSolver(nlp, _pars(DP_OPTS)).init(np.zeros((5, nlp.n)))
        with pytest.raises(ValueError, match="not divisible"):
            solver.shard_state(odd)


def _slice_rows(tree, rows):
    """`tree` (numpy leaves) with every array's leading axis sliced."""
    if isinstance(tree, np.ndarray):
        return tree[rows]
    if isinstance(tree, dict):
        return {k: _slice_rows(v, rows) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_slice_rows(v, rows) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def test_shared_matrix_product_depends_on_batch_size():
    """Why the bound-shift leg is held to 1e-12 and not bit for bit: its LP
    has a constant Jacobian, shared by the batch as one (m, n) matrix, and
    the CPU's matrix product (B, n) @ (n, m) rounds a row differently at
    B = 2 (a rank's rows) than at B = 4."""
    nlp, x0s, _ = _dp_case("shift")
    # the kernel's folded constant and its product (nlp._mv: v @ J^T)
    J = nlp.jac_orig(torch.as_tensor(x0s[:1]))[0].contiguous()
    v = torch.as_tensor(np.random.default_rng(0).normal(size=x0s.shape))
    whole, half = v @ J.T, v[:2] @ J.T
    assert not torch.equal(whole[:2], half)
    torch.testing.assert_close(whole[:2], half, rtol=1e-14, atol=1e-14)


def test_batched_bound_shift_campaign(tmp_path):
    """The shifted bound values (CanonNLP.shifted_bvals) equal the JAX
    package's, and the campaign's statuses are the reference's."""
    full, _, (_, _, jbvals) = _dp_leg(tmp_path, "shift", exact=False)
    from onephase_tpu_torch.ipm.state import STATUS_NAMES
    names = ["Optimal", "primal_infeasible", "primal_infeasible"]
    assert [STATUS_NAMES[int(s)] for s in full.status[:3]] == names
    nlp, _, bvals = _dp_case("shift")
    got = state_to_numpy(bvals)
    for k, v in jbvals.items():
        np.testing.assert_array_equal(got[k], v)
    one = nlp.shifted_bvals(25.0)
    np.testing.assert_array_equal(one["l"].numpy(), got["l"][1])
    assert one["lv"] is nlp.default_bvals()["lv"]


# ----------------------------------------------------------------------
# test_block_schur.py::test_sharded_matches_local
@pytest.fixture(scope="module")
def arrow_runs(tmp_path_factory):
    """The ranks' sharded arrow solves and the JAX package's (run
    meanwhile)."""
    with _ranks(tmp_path_factory.mktemp("arrow"), _rank_arrow) as ranks:
        jax_out = _jax_sharded_arrow()
        outs = ranks.results()
    return outs, jax_out


@pytest.mark.parametrize("use_pallas", [False, True])
def test_sharded_arrow_matches_local(arrow_runs, use_pallas):
    outs, (jdz, jdxk, jok) = arrow_runs
    Qzz, Qkk, Bk, rz, rk = _arrow_data()
    delta = torch.full((1,), 1e-3, dtype=torch.float64)
    f = arrow_factor(_t(Qzz), _t(Qkk), _t(Bk), delta, use_pallas)
    dz, dxk = arrow_solve(f, _t(Bk), _t(rz), _t(rk))
    for r, out in enumerate(outs):
        dz_s, dxk_s, ok = out[use_pallas]
        assert ok.all()
        np.testing.assert_array_equal(dz_s, dz.numpy())
        np.testing.assert_array_equal(dxk_s, dxk.numpy()[:, 4 * r:4 * r + 4])
    assert bool(jok)
    np.testing.assert_allclose(dz.numpy()[0], jdz, rtol=0, atol=1e-10)
    np.testing.assert_allclose(dxk.numpy()[0], jdxk, rtol=0, atol=1e-10)


def test_gather_is_exact(arrow_runs):
    v = np.array([-0.0, np.inf, -np.inf, np.nan, 1e-310, -3.5])
    want = np.stack([v, 2 * v])
    for out in arrow_runs[0]:
        _equal(out["gather"], want)
        assert np.signbit(out["gather"][:, 0]).all()


# ----------------------------------------------------------------------
# test_chain / test_banded / test_scenario: *_sharded_matches_unsharded
_JAX_STRUCT = {}


@pytest.mark.parametrize("name,lane", STRUCT_LEGS)
def test_structured_sharded_matches_unsharded(tmp_path, name, lane):
    with _ranks(tmp_path, _rank_structured, name, lane) as ranks:
        if name not in _JAX_STRUCT:
            _JAX_STRUCT[name] = _jax_structured(name)
        k = _structured(name, lane)
        full = _replicated(k.run_chunk(k.initial_state()))
        outs = ranks.results()
    assert full["status"].tolist() == [OPTIMAL]
    for out in outs:
        _equal(out, full)
    _held_to_jax(full, _JAX_STRUCT[name])


# ----------------------------------------------------------------------
# validation: the JAX package's errors, before any collective
def _chain_kernel(mesh, **over):
    pars = _pars(STRUCT_OPTS, **over)
    return ChainKernel(chain_ocp(K=12, nx=2, mc=1, device=CPU), pars,
                       device=CPU, mesh=mesh)


def _banded_kernel(mesh, **over):
    nlp = canonicalize(chain_ocp(K=12, nx=2, mc=1, device=CPU).to_nlpspec(),
                       device=CPU)
    return BandedKernel(nlp, _pars(STRUCT_OPTS, **over), device=CPU,
                        mesh=mesh)


@pytest.mark.parametrize("make", [_chain_kernel, _banded_kernel],
                         ids=["chain", "banded"])
@pytest.mark.parametrize("axis,over,match", [
    ("chain", {}, "a mesh requires kkt.chain_partitions > 1"),
    ("dp", {"kkt.chain_partitions": 2}, "mesh has no axis 'chain'"),
    ("chain", {"kkt.chain_partitions": 3},
     "kkt.chain_partitions=3 must be divisible by the mesh 'chain' axis "
     "size 2"),
    ("chain", {"kkt.chain_partitions": 2, "kkt.linear_solver_type":
               "pallas"}, "pallas tridiag backend is sequential"),
], ids=["no_partitions", "missing_axis", "indivisible", "pallas"])
def test_mesh_validation(make, axis, over, match):
    with pytest.raises(ValueError, match=match):
        make(Mesh(None, axis, 0, WORLD, CPU), **over)


def test_scenario_sharded_rejects_indivisible_k():
    pars = _pars(STRUCT_OPTS)
    with pytest.raises(ValueError, match="K=7 not divisible by mesh axis "
                                         "'blk' size 2"):
        ScenarioKernel(two_stage_qp(K=7, device=CPU), pars, device=CPU,
                       mesh=Mesh(None, "blk", 0, WORLD, CPU))
    with pytest.raises(ValueError, match="mesh has no axis 'blk'"):
        ScenarioKernel(two_stage_qp(K=8, device=CPU), pars, device=CPU,
                       mesh=Mesh(None, "dp", 0, WORLD, CPU))


def test_one_rank_mesh_and_distributed_init():
    """Outside a process group: a one-rank mesh (no collective), with which
    the sharded solver is the batch solver; distributed_init is a no-op
    for one process and takes no backend it is not given."""
    mesh = make_mesh(device=CPU)
    assert (mesh.group, mesh.rank, mesh.size, mesh.shape) == \
        (None, 0, 1, {"dp": 1})
    with pytest.raises(ValueError):
        make_mesh(2, device=CPU)
    distributed_init(num_processes=1)
    with pytest.raises(ValueError, match="backend"):
        distributed_init("localhost:1", num_processes=2, process_id=0)
    nlp, x0s, _ = _dp_case("mixed")
    a = ShardedBatchSolver(nlp, _dp_pars("mixed"))
    b = BatchSolver(nlp, _dp_pars("mixed"))
    _equal(state_to_numpy(a.gather(a.solve(x0s))),
           state_to_numpy(b.solve(x0s)))


def _rank_group(mesh):
    import torch.distributed as dist
    v = torch.tensor([[1.5, -0.0]], dtype=torch.float64)
    return (dist.is_initialized(), dist.get_backend(), mesh.size,
            mesh.group is not None, mesh.gather(v, 0).numpy())


def test_one_rank_group_from_a_store(tmp_path):
    """One process that names a store joins a one-rank group (a backend's
    path run alone, as the nccl leg on one card is): distributed_init, by
    way of the spawned rank, makes the group, and the gather runs its
    all_reduce."""
    with SpawnedRanks(_rank_group, 1, "gloo", CPU, timeout=RANK_TIMEOUT,
                      store_dir=str(tmp_path), threads=1) as ranks:
        (init, backend, size, grouped, gathered), = ranks.results()
    assert (init, backend, size, grouped) == (True, "gloo", 1, True)
    assert np.array_equal(gathered, [[1.5, -0.0]])
    assert np.signbit(gathered[0, 1])


def test_dryrun_multichip(tmp_path):
    """dryrun.dryrun_multichip on two CPU ranks (one group a rank on its
    blk leg): every leg to termination, Optimal, the ranks agreeing; the
    sharded arrow leg's (dz, dx_k) against the local arrow solve of the
    same blocks."""
    from onephase_tpu_torch.dryrun import arrow_blocks, dryrun_multichip
    legs = dryrun_multichip(WORLD, "gloo", "cpu", groups_per_rank=1,
                            timeout=RANK_TIMEOUT, store_dir=str(tmp_path),
                            threads=1)
    assert len(legs) == WORLD
    for rank in legs:
        assert [leg["leg"] for leg in rank] == ["dp", "blk", "arrow",
                                                "chain"]
        for leg in rank:
            assert leg["ok"]
            if leg["leg"] != "arrow":
                assert set(leg["statuses"]) == {"Optimal"}
        arrow = rank[2]
        Qzz, Qkk, Bk, rz, rk = arrow_blocks(arrow["K"])
        f = arrow_factor(_t(Qzz), _t(Qkk), _t(Bk),
                         torch.full((1,), 1e-6, dtype=torch.float64),
                         use_pallas=True)
        dz, dxk = arrow_solve(f, _t(Bk), _t(rz), _t(rk))
        np.testing.assert_allclose(arrow["dz"], dz.numpy(), rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(arrow["dxk"], dxk.numpy(), rtol=0,
                                   atol=1e-10)


def test_multihost_identity_from_mesh():
    from onephase_tpu_torch import harness as th
    mesh = Mesh(None, "dp", 1, 3, CPU)
    assert th._process_identity(None, None, mesh) == (1, 3)
    assert th._process_identity(0, None, mesh) == (0, 3)


# ----------------------------------------------------------------------
# ops/_build.py: two processes building one library at once
STUB = textwrap.dedent("""\
    import sys, time
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    if "-shared" in args:
        with open(sys.argv[0] + ".links", "a") as log:
            log.write("link\\n")
        srcs = [a for a in args[args.index("-o") + 2:]]
    else:
        srcs = [args[-1]]
    time.sleep(0.5)
    with open(out, "w") as fh:
        for s in srcs:
            fh.write(open(s).read())
""")

BUILDER = textwrap.dedent("""\
    import sys
    from pathlib import Path
    from onephase_tpu_torch.ops._build import _build
    d = Path(sys.argv[1])
    _build(d / "build" / "libk.so", sorted(d.glob("*.cu")), sys.argv[2])
""")


def test_concurrent_build_is_safe(tmp_path):
    """`_build` run by two processes at once against a stub compiler (no
    nvcc here): one compiles and links, the other waits and reuses the
    library; no object or temporary file is left behind."""
    stub = tmp_path / "nvcc_stub"
    stub.write_text("#!" + sys.executable + "\n" + STUB)
    stub.chmod(0o755)
    for name in ("a", "b", "c"):
        (tmp_path / f"{name}.cu").write_text(f"<{name}>")
    root = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root] + sys.path))
    procs = [subprocess.Popen([sys.executable, "-c", BUILDER, str(tmp_path),
                               str(stub)], env=env) for _ in range(2)]
    try:
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0, 0]
    build = tmp_path / "build"
    assert (build / "libk.so").read_text() == "<a><b><c>"
    assert sorted(p.name for p in build.iterdir()) == ["libk.lock",
                                                       "libk.so"]
    assert (tmp_path / "nvcc_stub.links").read_text() == "link\n"
