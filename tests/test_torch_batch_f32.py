"""Batched parity on the bench problem at a small size, float32 (see
test_torch_batch.py for float64)."""

import pytest
import torch

from test_torch_twins import check_batch_case


@pytest.mark.parametrize("dtype", [torch.float32])
def test_batch_matches_jax_and_single_solves(dtype):
    check_batch_case(dtype)
