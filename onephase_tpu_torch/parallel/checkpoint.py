"""Solver-state checkpoint/resume for long batched campaigns.

Port of onephase_tpu/parallel/checkpoint.py.  The reference only has
harness-level resume (skip problems already in summary.jld,
run_cutest.jl:116-134), kept in harness.py; this module snapshots the
solver *state* itself, so a large batched run can resume mid-solve.

A state is a tree of named tuples, tuples and dicts whose leaves are
tensors (or None).  Its tensor leaves, in a fixed depth-first order, go to
an .npz file; loading takes a `like` state of the same kernel and batch
shape for the structure, dtypes and device, and checks the leaf count and
every shape.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves(tree, out):
    """Append the tensor leaves of `tree` to `out`, depth first."""
    if tree is None:
        return out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, tuple):
        for v in tree:
            _leaves(v, out)
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__}")
    return out


def _rebuild(tree, it):
    """`tree` with each tensor leaf replaced by the next of `it`."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    vals = [_rebuild(v, it) for v in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def save_state(path: str, state) -> None:
    leaves = _leaves(state, [])
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    np.savez_compressed(path, n_leaves=len(leaves), **arrays)


def load_state(path: str, like):
    """Load a state saved by save_state; `like` provides the structure,
    dtypes and device (e.g. a freshly initialized state of the same
    kernel and batch shape)."""
    data = np.load(path)
    leaves_like = _leaves(like, [])
    n = int(data["n_leaves"])
    if n != len(leaves_like):
        raise ValueError(f"checkpoint has {n} leaves, expected "
                         f"{len(leaves_like)} — incompatible kernel/config")
    leaves = []
    for i, ref in enumerate(leaves_like):
        arr = data[f"leaf_{i}"]
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != "
                             f"{tuple(ref.shape)}")
        leaves.append(torch.as_tensor(arr).to(dtype=ref.dtype,
                                              device=ref.device))
    return _rebuild(like, iter(leaves))
