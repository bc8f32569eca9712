"""The host-side pieces of K3's inverse in the matmul modes, on the CPU:
the refusals of `tri_inv_phases`, which runs only on a card, and
chip_smoke.py's `inverse_residual`, the distance of an inverse from its
mode's recurrence that the card checks hold K3's moded inverse to.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from onephase_tpu_torch.ops import cholesky as ch
from onephase_tpu_torch.ops import precision
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_tri_inv_phases_refuses_cpu_and_float64():
    """tri_inv_phases runs the clocked kernels: a CPU factor, float32 or
    float64, raises (no twin stands in for a measurement)."""
    for dt in (torch.float32, torch.float64):
        L = torch.eye(5, dtype=dt).repeat(2, 1, 1)
        with pytest.raises(ValueError):
            ch.tri_inv_phases(L)


@pytest.mark.parametrize("mode_name", [str(m) for m in precision.CARD_MODES])
def test_inverse_residual_reads_the_modes_recurrence(mode_name):
    """The twin's inverse in a mode (its 32-row recurrence, float32 sums)
    lies at float32 rounding from that mode's recurrence, as the residual
    reads it; the IEEE inverse lies further from it where the mode rounds
    each operand once (one product an entry), and so does the twin's
    inverse with its largest entry moved by 1e-5 of its value."""
    mode = next(m for m in precision.CARD_MODES if str(m) == mode_name)
    res = _smoke().inverse_residual
    rng = np.random.default_rng(3)
    n = 70
    A = rng.normal(size=(2, n, n))
    S = torch.as_tensor(A @ A.transpose(0, 2, 1) + n * np.eye(n),
                        dtype=torch.float32)
    L = torch.linalg.cholesky(S)
    X = ch.blocked_tri_inv(L, mode=mode)
    own = res(L, X, mode)
    assert 0.0 < own <= 1e-6
    if mode.passes == 1:
        assert res(L, ch.blocked_tri_inv(L, mode=precision.IEEE), mode) \
            >= 10.0 * own
    Y = X.contiguous().clone().view(-1)
    Y[Y.abs().argmax()] *= 1.0 + 1e-5
    assert res(L, Y.view_as(X), mode) >= 10.0 * own
