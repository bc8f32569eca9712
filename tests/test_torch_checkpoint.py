"""The port's solver-state checkpoint (parallel/checkpoint.py): a state
saved mid-solve and loaded into a fresh state of the same kernel resumes
to the same final state, bit for bit, as the uninterrupted solve (CPU);
tests/test_harness.py's checkpoint case certifies as the JAX package's
does; incompatible checkpoints are refused.  Also a parametric bucket's
state (its pdata dict) and a float32 factor in a float64 state."""

import numpy as np
import pytest
import torch

from onephase_tpu_torch.config import Params
from onephase_tpu_torch.ipm.state import RUNNING
from onephase_tpu_torch.models import zoo
from onephase_tpu_torch.nlp import canonicalize
from onephase_tpu_torch.parallel.batch import BatchSolver
from onephase_tpu_torch.parallel.checkpoint import load_state, save_state
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BASE = {"term!max_it": 81, "a_norm_penalty": 1e-4, "output_level": 0}


def _leaves(tree, out):
    if tree is None:
        return out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    else:
        for v in tree:
            _leaves(v, out)
    return out


def _run_to_end(solver, st, limit=60):
    for _ in range(limit):
        if not bool((st.status == RUNNING).any()):
            break
        st = solver.run_chunk(st)
    return st


def _assert_bit_equal(a, b):
    la, lb = _leaves(a, []), _leaves(b, [])
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _resume_case(tmp_path, solver, x0s, **init):
    st = solver.run_chunk(solver.init(x0s, **init))
    path = str(tmp_path / "ckpt.npz")
    save_state(path, st)
    st2 = load_state(path, solver.init(x0s, **init))
    _assert_bit_equal(st2, st)
    resumed = _run_to_end(solver, st2)
    straight = _run_to_end(solver, st)
    _assert_bit_equal(resumed, straight)
    return resumed


def test_checkpoint_resume_bit_for_bit(tmp_path):
    """tests/test_harness.py's case: circle_nc2, chunks of two outer
    iterations, a checkpoint after the first chunk; the resumed solve
    certifies both instances and equals the uninterrupted one."""
    solver = BatchSolver(canonicalize(zoo.circle_nc2(), device="cpu"),
                         Params().with_overrides(dict(
                             BASE, chunk_size=2, history_capacity=2)))
    st = _resume_case(tmp_path, solver, np.array([[1.0, 1.0], [0.5, 1.5]]))
    assert solver.statuses(st) == ["Optimal", "Optimal"]


def test_checkpoint_parametric_bucket_state(tmp_path):
    """A bucket's state: per-instance pdata (A, c, c0), bound values and
    the carried per-instance Jacobian, float32 with its float64 extras."""
    from onephase_tpu_torch.parallel.buckets import bucket_template, pad_lp
    from onephase_tpu_torch.models.lp import LPData
    rng = np.random.default_rng(0)
    lps = [LPData(cvec=rng.normal(size=3), A=rng.normal(size=(2, 3)),
                  lcon=np.full(2, -1.0), ucon=np.full(2, 1.0),
                  lvar=np.zeros(3), uvar=np.full(3, 2.0)) for _ in range(2)]
    padded = [pad_lp(d, 4, 2) for d in lps]
    nlp = canonicalize(bucket_template(4, 2), dtype=torch.float32,
                       device="cpu")
    solver = BatchSolver(nlp, Params().with_overrides(dict(
        BASE, chunk_size=3, **{"term.tol_opt": 1e-4})))
    pdata = {"A": np.stack([p.A for p in padded]),
             "c": np.stack([p.cvec for p in padded]),
             "c0": np.zeros(2)}
    bvals = {k: torch.as_tensor(np.stack([getattr(p, f) for p in padded]),
                                dtype=torch.float32)
             for k, f in (("l", "lcon"), ("u", "ucon"), ("lv", "lvar"),
                          ("uv", "uvar"))}
    st = _resume_case(tmp_path, solver, np.stack([p.x0 for p in padded]),
                      bvals=bvals, pdata=pdata)
    assert solver.statuses(st) == ["Optimal", "Optimal"]
    assert st.fact.Jc.shape == (2, 2, 4)


def test_checkpoint_keeps_float32_factor_of_float64_state(tmp_path):
    solver = BatchSolver(canonicalize(zoo.circle1(), device="cpu"),
                         Params().with_overrides(dict(
                             BASE, chunk_size=3,
                             **{"kkt.factor_precision": "f32",
                                "kkt.linear_solver_type": "pallas"})))
    st = _resume_case(tmp_path, solver, np.array([[0.5, 0.5]]))
    assert st.fact.L.dtype == torch.float32
    assert st.p.x.dtype == torch.float64


def test_incompatible_checkpoints_refused(tmp_path):
    a = BatchSolver(canonicalize(zoo.circle_nc2(), device="cpu"),
                    Params().with_overrides(dict(BASE, history_capacity=2)))
    st = a.init(np.array([[1.0, 1.0], [0.5, 1.5]]))
    path = str(tmp_path / "ckpt.npz")
    save_state(path, st)
    with pytest.raises(ValueError, match="shape"):
        load_state(path, a.init(np.array([[1.0, 1.0]])))
    b = BatchSolver(canonicalize(zoo.circle_nc2(), device="cpu"),
                    Params().with_overrides(dict(
                        BASE, history_capacity=2,
                        **{"term.stall_patience": 0,
                           "term.unbounded_ray_patience": 0})))
    with pytest.raises(ValueError, match="leaves"):
        load_state(path, b.init(np.array([[1.0, 1.0], [0.5, 1.5]])))
