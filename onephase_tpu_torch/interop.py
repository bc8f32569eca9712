"""Carry solver state across from the JAX package, and back to numpy.

For a solver the "weights" are the problem data (built from the same numpy
arrays in both packages, see models/) and the solver state.  The JAX
package's `State` is a pytree; a caller turns it into numpy first
(`jax.tree_util.tree_map(np.asarray, st)`), so this module needs no JAX.
Field names are those of ipm/state.py in both packages.

- A JAX state without a batch axis gets one (a single solve is a batch of
  1 in the port).
- The JAX package's (0, 0) placeholders (folded-constant Jacobian/Hessian,
  the dense path's Q) become ``None``, as the port carries them.
"""

from __future__ import annotations

import numpy as np
import torch

from .ipm.state import (Cache, Dir, Factor, Filter, History, LSInfo, Point,
                        State)

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
    else:
        dt = dtype
    return torch.as_tensor(arr, dtype=dt, device=device)


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
              and np.asarray(v).shape[-2:] == (0, 0)):
            vals[name] = None
        else:
            vals[name] = _to_tensor(v, dtype, device, add_batch)
    return cls(**vals)


def state_from_numpy(tree, dtype=torch.float64, device=None) -> State:
    """The port's `State` from a JAX `State` whose leaves are numpy arrays
    (batched or not); float leaves take `dtype`, on `device`."""
    add_batch = np.asarray(tree.p.x).ndim == 1
    dev = torch.device(device) if device is not None else torch.device("cpu")
    return _convert(tree, State, dtype, dev, add_batch)


def state_to_numpy(st):
    """The same tree with numpy leaves (batch axis kept, None kept)."""
    if st is None:
        return None
    if isinstance(st, torch.Tensor):
        return st.detach().cpu().numpy()
    if isinstance(st, dict):
        return {k: state_to_numpy(v) for k, v in st.items()}
    return type(st)(*[state_to_numpy(v) for v in st])
