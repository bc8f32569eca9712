"""Dense LP models: the data form and its NLPSpec, and the infeasible
perturbation.

Port of the data half of onephase_tpu/models/lp.py (`LPData`, `lp_spec`,
`perturb_infeasible`).  The spec declares a constant Jacobian and a zero
Hessian, so the Schur-dual path (ipm/dual.py) takes it.  Reading and
writing MPS files is not ported yet.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..nlp import NLPSpec, resolve_device
from .qp import Data

INF = np.inf


@dataclass
class LPData:
    """Raw dense LP: min c^T x + c0 s.t. lcon <= A x <= ucon,
    lvar <= x <= uvar (host float64 arrays)."""

    cvec: np.ndarray
    A: np.ndarray
    lcon: np.ndarray
    ucon: np.ndarray
    lvar: np.ndarray
    uvar: np.ndarray
    x0: Optional[np.ndarray] = None
    name: str = "lp"
    c0: float = 0.0
    # "max" records an OBJSENSE MAX source; cvec/c0 are already negated to
    # min-form, so the min-form optimum is -(the source's optimum)
    objsense: str = "min"

    @property
    def n(self):
        return self.A.shape[1]

    @property
    def m(self):
        return self.A.shape[0]

    def to_spec(self, device=None) -> NLPSpec:
        return lp_spec(self.cvec, self.A, self.lcon, self.ucon, self.lvar,
                       self.uvar, self.x0, name=self.name, c0=self.c0,
                       device=device)


def lp_spec(cvec, A, lcon, ucon, lvar=None, uvar=None, x0=None,
            name="lp", c0: float = 0.0, device=None) -> NLPSpec:
    """min c^T x + c0  s.t. lcon <= A x <= ucon, lvar <= x <= uvar.  The
    data lives on `device` (default: the CUDA card)."""
    A = np.asarray(A, dtype=np.float64)
    m, n = A.shape
    dev = resolve_device(device)
    At = Data(A, dev)
    ct = Data(np.asarray(cvec, dtype=np.float64), dev)
    return NLPSpec(
        f=lambda x: torch.dot(ct(x.dtype), x) + c0,
        c=(lambda x: At(x.dtype) @ x) if m > 0 else None,
        lcon=np.asarray(lcon, dtype=np.float64) if m > 0 else None,
        ucon=np.asarray(ucon, dtype=np.float64) if m > 0 else None,
        lvar=lvar if lvar is not None else np.full(n, -INF),
        uvar=uvar if uvar is not None else np.full(n, INF),
        x0=x0 if x0 is not None else np.zeros(n),
        lin=tuple(range(m)), name=name,
        constant_jac=True, constant_hess=True, zero_hess=True)


def perturb_infeasible(spec: NLPSpec, scale: float = 1.0) -> NLPSpec:
    """Shift the constraint ranges by -scale (reference perturb_cons,
    infeas.jl:3-33)."""
    out = copy.copy(spec)
    out.lcon = spec.lcon - scale
    out.ucon = spec.ucon - scale
    out.name = spec.name + "_infeas"
    return out
