"""Batched parity on the bench problem at a small size, float64: the port's
`BatchSolver` on the `pallas` lane against the JAX package's (pallas lane,
interpret mode), and the port's batched instances against its own single
solves."""

import pytest
import torch

from test_torch_twins import check_batch_case
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("dtype", [torch.float64])
def test_batch_matches_jax_and_single_solves(dtype):
    check_batch_case(dtype)
