"""The host-side pieces of K7's and K5's matmul-mode instantiations, on the
CPU: the switches of csrc/tridiag_factor_mode.cu and
csrc/tridiag_solve_mode.cu that take a mode's code to its instantiation,
against the codes csrc/mm_mode.cuh's mm_mode_valid accepts and the card
modes; the refusal of every other code; the clocked library's sources;
and the refusals of `tridiag_phases`, which runs only on a card.
"""

import re
from pathlib import Path

import pytest
import torch

from onephase_tpu_torch.ops import _build
from onephase_tpu_torch.ops import precision
from onephase_tpu_torch.ops import tridiag_pallas as tp

CSRC = Path(_build.CSRC)
MODE_SOURCES = ("tridiag_factor_mode.cu", "tridiag_solve_mode.cu")


def _mm_mode_valid(code):
    """csrc/mm_mode.cuh's mm_mode_valid, for the codes other than 0."""
    kind, passes = code >> 4, code & 15
    if kind == 3:
        return passes == 1
    if kind == 1:
        return passes in (1, 3)
    if kind == 2:
        return passes in (1, 3, 6, 9)
    return False


def _switch_codes(name):
    """The case labels of the mode switch in csrc/`name`."""
    return {int(c, 16) for c in
            re.findall(r"case (0x[0-9a-f]+):", (CSRC / name).read_text())}


def test_mm_mode_valid_port_reads_the_header():
    """The port of mm_mode_valid above has the header's cases."""
    text = (CSRC / "mm_mode.cuh").read_text()
    body = text[text.index("inline bool mm_mode_valid"):]
    body = body[:body.index("\n}\n")]
    assert "m.kind == 3) return m.passes == 1" in body
    assert "m.kind == 1) return m.passes == 1 || m.passes == 3" in body
    assert ("return m.passes == 1 || m.passes == 3 || m.passes == 6 || "
            "m.passes == 9") in body


def test_every_valid_code_reaches_one_instantiation():
    """The codes mm_mode_valid accepts are the card modes' codes, each one
    case of each kernel's switch, which names that mode's kind and pass
    count (launch_mode<KIND, PASSES>)."""
    valid = {c for c in range(1, 256) if _mm_mode_valid(c)}
    assert valid == {m.code for m in precision.CARD_MODES}
    for name in MODE_SOURCES:
        text = (CSRC / name).read_text()
        assert _switch_codes(name) == valid, name
        for c in valid:
            assert re.search(rf"case {c:#x}:\s*return launch_mode<{c >> 4}, "
                             rf"{c & 15}>", text), (name, hex(c))


def test_other_codes_raise():
    """Every other code reaches each switch's default, which returns an
    error (the wrappers raise it: nothing runs a refused mode as IEEE)."""
    for name in MODE_SOURCES:
        text = re.sub(r"\s+", " ", (CSRC / name).read_text())
        switch = text[text.index("switch (mode)"):]
        switch = switch[:switch.index("} }")]
        assert switch.count("case ") == 7
        assert "default: return (int)cudaErrorInvalidValue;" in switch, name


def test_clocked_library_sources():
    """clock_library("tridiag") compiles every source of K7 and K5 with the
    clock flag, and names both clocked entry points."""
    files, flag, entries = _build._CLOCKED["tridiag"]
    assert set(files) == {"tridiag.cu", *MODE_SOURCES}
    assert all((CSRC / f).exists() for f in files)
    assert flag == "-DONEPHASE_TRIDIAG_CLOCKS"
    text = (CSRC / "tridiag.cu").read_text()
    for name in entries:
        assert f'extern "C" int {name}(' in text


def test_tridiag_phases_refuses_cpu_and_float64():
    """tridiag_phases runs the clocked kernels: a CPU band, float32 or
    float64, raises (no twin stands in for a measurement)."""
    for dt in (torch.float32, torch.float64):
        Ad = torch.eye(4, dtype=dt).repeat(1, 3, 1, 1) * 3.0
        Bs = torch.zeros(1, 2, 4, 4, dtype=dt)
        b = torch.ones(1, 3, 4, dtype=dt)
        with pytest.raises(ValueError):
            tp.tridiag_phases(Ad, Bs, 0.0, b)
    assert tp.TRIDIAG_PHASES["factor"][0] == "other"
    assert len(tp.TRIDIAG_PHASES["factor"]) == len(tp.TRIDIAG_PHASES["solve"])
