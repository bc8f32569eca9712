"""Structured example problems (port of onephase_tpu/models/examples.py).

Only `chain_ocp` is ported so far: the other examples (scenario and
two-stage problems) wait for their kernels.  The data comes from the same
numpy `default_rng(seed)` draws in the same order as the JAX package's, so
the two packages solve the same problem bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nlp import resolve_device
from .qp import Data


def chain_ocp(K: int = 16, nx: int = 8, mc: int = 4, seed: int = 0,
              device=None):
    """Stage-chained QP (multiple-shooting OCP shape) for the
    block-tridiagonal path (parallel/chain.py): per-stage tracking costs
    with cross terms and mc coupling constraints per adjacent pair -- the
    scalable analogue of the CHAIN smoke problem (reference
    test/CUTEst.jl:11-30).  The data lives on `device` (default: the CUDA
    card) in float32 and float64."""
    from ..parallel.chain import ChainSpec

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    Km = K - 1
    Pk = rng.normal(size=(Km, nx, nx))
    Pk = np.einsum("kij,klj->kil", Pk, Pk) / nx + np.eye(nx) * 0.5
    qk = rng.normal(size=(Km, nx)) * 0.3
    Ck = rng.normal(size=(Km, nx, nx)) * (0.3 / np.sqrt(nx))
    Ak = rng.normal(size=(Km, mc, nx)) / np.sqrt(nx)
    Dk = rng.normal(size=(Km, mc, nx)) / np.sqrt(nx)
    bk = rng.normal(size=(Km, mc)) * 0.1

    data = {k: Data(v, device) for k, v in
            {"P": Pk, "q": qk, "C": Ck, "A": Ak, "D": Dk, "b": bk}.items()}

    def fk(xa, xb, d):
        return (0.5 * xa @ d["P"] @ xa + d["q"] @ xa
                + xa @ d["C"] @ xb + 0.05 * torch.dot(xb, xb))

    def ck(xa, xb, d):
        return d["D"] @ xb - d["A"] @ xa - d["b"]

    return ChainSpec(
        fk=fk, ck=ck, data=data, K=K, nx=nx, mc=mc,
        lcon=np.zeros(mc), ucon=np.full(mc, np.inf),
        lx=np.full(nx, -10.0), ux=np.full(nx, 10.0),
        x0=np.zeros(nx), name=f"chain_ocp_K{K}_nx{nx}")
