"""The lean launch path of K1 and K2 (`ops/schur.py`, `ops/cholesky.py`,
`ops/_build.py`, `ops/__init__.py`), on the CPU.

On the card a wrapper checks each operand once, cheaply, and raises the
errors it raised before on a bad one.  Here: the operand check refuses
each kind of bad operand (dtype, shape, layout, device) with its error and
accepts a good one; the wrappers refuse a batch off the card as before; on
CPU tensors they still give their plain versions' values and count no
launch; a launch's tally names its mode as `str(mode)` does.
"""

import numpy as np
import pytest
import torch

from onephase_tpu_torch import ops
from onephase_tpu_torch.ops import _build
from onephase_tpu_torch.ops import cholesky as ch
from onephase_tpu_torch.ops import precision, schur
from test_torch_twins import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, M, N = 3, 5, 4


def _operand(kind):
    """(w, the device index the check expects): w (B, M) in float64, made
    bad in the way `kind` names (for "device" the check expects cuda:0 and
    w lies on the CPU)."""
    w = torch.ones(B, M, dtype=torch.float64)
    idx = -1
    if kind == "dtype":
        w = w.float()
    elif kind == "shape":
        w = torch.ones(B, M + 1, dtype=torch.float64)
    elif kind == "stride":
        w = torch.ones(M, B, dtype=torch.float64).mT
    elif kind == "device":
        idx = 0
    return w, idx


@pytest.mark.parametrize("kind, msg", [
    ("good", None),
    ("dtype", "w is torch.float32 on cpu, expected torch.float64"),
    ("shape", r"w has shape \(3, 6\), expected one of \[\(3, 5\)\]"),
    ("stride", "w must be contiguous"),
    ("device", "w is torch.float64 on cpu, expected torch.float64 on cuda:0"),
])
def test_operand_check_refuses_each_bad_operand(kind, msg):
    """The operand check raises its error, as before, on each kind of bad
    operand, and nothing on a good one."""
    w, idx = _operand(kind)
    if msg is None:
        schur._check_operand(w, "w", [(B, M)], torch.float64, idx)
        return
    with pytest.raises(ValueError, match=msg):
        schur._check_operand(w, "w", [(B, M)], torch.float64, idx)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cuda_operands_refuse_a_batch_off_the_card(device):
    """The kernel's operand check refuses a batch that is not on a card,
    with the error it gave before; the wrapper refuses a batch on a device
    with neither a kernel nor a plain route (meta) the same way."""
    bnd = torch.ones(B, N, dtype=torch.float64, device=device)
    Jc = torch.ones(M, N, dtype=torch.float64, device=device)
    w = torch.ones(B, M, dtype=torch.float64, device=device)
    with pytest.raises(ValueError, match=f"no kernel for device {device}"):
        schur._cuda_operands(Jc, w, None, bnd)
    if device == "meta":
        with pytest.raises(ValueError, match="no kernel for device meta"):
            schur.pallas_fused_q(Jc, w, None, bnd)


@pytest.mark.parametrize("bad, err", [
    (torch.zeros(2, 3, 4), ValueError),
    (torch.zeros(3, 3), ValueError),
    (torch.zeros(2, 3, 3, dtype=torch.int32), TypeError),
    (torch.zeros(2, 3, 3, device="meta"), ValueError),
])
def test_chol_refuses_as_before(bad, err):
    with pytest.raises(err):
        ch.pallas_chol(bad)


def test_entry_refuses_other_dtypes_before_building():
    """A dtype without a kernel raises TypeError without a build (there is
    no nvcc here)."""
    with pytest.raises(TypeError):
        _build.entry("op_chol", torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_wrappers_give_plain_values_and_count_no_launch(dtype):
    rng = np.random.default_rng(4)
    n, m, b = 20, 7, 3
    A = rng.normal(size=(b, n, n))
    Q = torch.as_tensor(A @ A.transpose(0, 2, 1) + n * np.eye(n),
                        dtype=dtype)
    Jc = torch.as_tensor(rng.normal(size=(m, n)), dtype=dtype)
    w = torch.as_tensor(rng.uniform(0.1, 2.0, size=(b, m)), dtype=dtype)
    H = Q[0].clone()
    bnd = torch.as_tensor(rng.uniform(0.0, 1.0, size=(b, n)), dtype=dtype)
    ops.reset_launch_counts()
    L, d, ok = ch.pallas_chol(Q)
    Lr, dr, okr = ch.xla_chol(Q)
    assert torch.equal(L, Lr) and torch.equal(d, dr) and torch.equal(ok, okr)
    assert ok.dtype == torch.bool
    Qf = schur.pallas_fused_q(Jc, w, H, bnd)
    assert torch.equal(Qf, schur.xla_fused_q(Jc, w, H, bnd,
                                             mode=precision.IEEE))
    assert ops.launch_counts() == dict.fromkeys(ops.LAUNCHES, 0)
    assert ops.launch_modes() == {}


def test_count_launch_names_each_mode_as_str():
    ops.reset_launch_counts()
    for md in (precision.IEEE,) + precision.CARD_MODES:
        ops.count_launch("chol", md)
        ops.count_launch("chol", md)
    assert ops.launch_modes() == {"chol": {
        str(md): 2 for md in (precision.IEEE,) + precision.CARD_MODES}}
    assert ops.launch_counts()["chol"] == 2 * (1 + len(precision.CARD_MODES))
    ops.reset_launch_counts()
