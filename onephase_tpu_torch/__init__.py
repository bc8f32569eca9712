"""PyTorch / CUDA port of onephase_tpu: the one-phase interior-point solver
of Hinder & Ye on batch-first tensors, with hand-written Hopper kernels on
the `pallas` lane (`ops/`, `csrc/`).

The JAX package `onephase_tpu` is the reference the port is tested against;
this package imports torch and numpy, never jax.
"""

from .config import Params
from .nlp import NLPSpec, CanonNLP, canonicalize
from .solver import one_phase_solve, Result, EvalNaNError

__all__ = [
    "Params", "NLPSpec", "CanonNLP", "canonicalize",
    "one_phase_solve", "Result", "EvalNaNError",
]

__version__ = "0.1.0"
