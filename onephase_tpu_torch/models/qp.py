"""Random strictly-convex QP with linear constraints and bounds: the torch
twin of `bench.make_qp` (bench.py:44-62), built from the same numpy
`default_rng(seed)` draws so the data matches bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nlp import NLPSpec, resolve_device


class Data:
    """A float64 host array as device tensors in float32 and float64 (the
    solve dtype in the loop, float64 in the `_hi` oracles).  Both copies
    are made here, outside any `torch.func` transform."""

    def __init__(self, arr: np.ndarray, device):
        self._by_dtype = {dt: torch.as_tensor(arr, dtype=dt, device=device)
                          for dt in (torch.float32, torch.float64)}

    def __call__(self, dtype):
        return self._by_dtype[dtype]


def make_qp(n=256, m=128, seed=0, device=None):
    """min 0.5 ||A x||^2 + b.x  s.t.  -1 <= C x <= 1,  -10 <= x <= 10.
    The data lives on `device` (default: the CUDA card)."""
    rng = np.random.default_rng(seed)
    device = resolve_device(device)
    A = Data(rng.normal(size=(n, n)) / np.sqrt(n), device)
    b = Data(rng.normal(size=n), device)
    C = Data(rng.normal(size=(m, n)) / np.sqrt(n), device)
    return NLPSpec(
        f=lambda x: 0.5 * torch.sum((A(x.dtype) @ x) ** 2)
        + torch.dot(b(x.dtype), x),
        c=lambda x: C(x.dtype) @ x,
        lcon=np.full(m, -1.0), ucon=np.full(m, 1.0),
        lvar=np.full(n, -10.0), uvar=np.full(n, 10.0),
        x0=np.zeros(n), lin=tuple(range(m)),
        name=f"bench_qp_n{n}_m{m}",
        constant_jac=True, constant_hess=True)
