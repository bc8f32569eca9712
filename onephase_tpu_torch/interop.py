"""Carry solver state across from the JAX package, and back to numpy.

For a solver the "weights" are the problem data (built from the same numpy
arrays in both packages, see models/) and the solver state.  The JAX
package's `State` is a pytree; a caller turns it into numpy first
(`jax.tree_util.tree_map(np.asarray, st)`), so this module needs no JAX.
Field names are those of ipm/state.py in both packages.

- A float64 state keeps its float32 leaves: under the precision knobs
  (`kkt.factor_precision`, `precond_f32`, `fallback_form_f32`) the factor,
  Q or the solve operator are carried in float32.
- A JAX state without a batch axis gets one (a single solve is a batch of
  1 in the port).
- The JAX package's (0, 0) placeholders (folded-constant Jacobian/Hessian,
  the dense path's Q) become ``None``, as the port carries them.
- A structured kernel's tuple-valued Factor fields (the chain's
  Jc=(Ja, Jb), H=(Hd, Hs), Q=(Qd, Qs), L=(Ci or Ck, Ek)) are carried
  element by element; so are the banded kernel's Q=(Qd, Qs) and L, and in
  its matrix-free mode the `Jc` slot holding x (n,) and the `H` slot
  holding mu (a scalar), which become (B, n) and (B,).  A named tuple there
  (a partitioned factor) is not carried and raises.
- The scenario kernel's tuples (Jc=(Jx, Jz), H=(Hzz, Hkk, Hkz),
  Q=(Qzz, Qkk, Bk), L=(Lk, LS)) are carried element by element, each with
  the batch axis added.
- The symmetric paths' Factor carries K in Q, the LDL^T or eigh pair in
  (L, D) and, on clever_symmetric under kkt_system_rescale, `rescale`.
- A parametric problem's `pdata` (and the bound values `bvals`) are
  dicts: each leaf becomes a tensor with the batch axis (float leaves in
  `dtype`), so both packages can start from one state.  A non-parametric
  state's empty `pdata` stays empty.  Under parametric constant structure
  the Factor's Jc (H) holds the instance's own matrix and is carried as
  it is.
- The Schur-dual kernel's tuples: its Q slot, (wc, bnd, Jc) while forming
  and an all-empty placeholder tuple when carried, becomes ``None``; its L
  slot (S^-1, d^-1, A) keeps its elements, with a (0, 0) A (the folded
  constant Jacobian) as ``None``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ipm.state import (Cache, Dir, Factor, Filter, History, LSInfo, Point,
                        State)
from .nlp import resolve_device

_TYPES = {"p": Point, "cache": Cache, "fact": Factor, "dir": Dir,
          "filt": Filter, "hist": History, "ls": LSInfo}
_PLACEHOLDERS = ("Jc", "H", "Q")


def _to_tensor(a, dtype, device, add_batch):
    arr = np.array(a)   # a writable copy
    if add_batch:
        arr = arr[None]
    if arr.dtype == np.bool_:
        dt = torch.bool
    elif np.issubdtype(arr.dtype, np.integer):
        dt = torch.int32
    elif arr.dtype == np.float32 and dtype == torch.float64:
        dt = torch.float32      # a float32 factor of a float64 solve
    else:
        dt = dtype
    return torch.as_tensor(arr, dtype=dt, device=device)


def _empty_matrix(v):
    return np.asarray(v).ndim >= 2 and np.asarray(v).shape[-2:] == (0, 0)


def _leaf(v, dtype, device, add_batch):
    """A tensor, or a tuple of them converted element by element (a (0, 0)
    placeholder in a tuple becomes None)."""
    if not isinstance(v, tuple):
        return _to_tensor(v, dtype, device, add_batch)
    if hasattr(v, "_fields"):
        raise TypeError(f"state_from_numpy does not carry a "
                        f"{type(v).__name__}")
    return tuple(None if _empty_matrix(x)
                 else _leaf(x, dtype, device, add_batch) for x in v)


def _convert(tree, cls, dtype, device, add_batch):
    vals = {}
    for name in cls._fields:
        v = getattr(tree, name, None)
        if v is None:
            vals[name] = None
        elif name in _TYPES:
            vals[name] = _convert(v, _TYPES[name], dtype, device, add_batch)
        elif isinstance(v, dict):
            vals[name] = {k: _to_tensor(x, dtype, device, add_batch)
                          for k, x in v.items()}
        elif (cls is Factor and name in _PLACEHOLDERS
              and (all(np.asarray(x).size == 0 for x in v)
                   if isinstance(v, tuple) else _empty_matrix(v))):
            vals[name] = None
        else:
            vals[name] = _leaf(v, dtype, device, add_batch)
    return cls(**vals)


def state_from_numpy(tree, dtype=torch.float64, device=None) -> State:
    """The port's `State` from a JAX `State` whose leaves are numpy arrays
    (batched or not); float leaves take `dtype`, on `device` (default: the
    CUDA card), except that a float64 state keeps its float32 leaves (the
    factor and solve operator under the float32 factor knobs)."""
    add_batch = np.asarray(tree.p.x).ndim == 1
    dev = resolve_device(device)
    return _convert(tree, State, dtype, dev, add_batch)


def state_to_numpy(st):
    """The same tree with numpy leaves (batch axis kept, None kept)."""
    if st is None:
        return None
    if isinstance(st, torch.Tensor):
        return st.detach().cpu().numpy()
    if isinstance(st, dict):
        return {k: state_to_numpy(v) for k, v in st.items()}
    vals = [state_to_numpy(v) for v in st]
    return type(st)(*vals) if hasattr(st, "_fields") else tuple(vals)
