#!/usr/bin/env python3
"""Check chip_smoke.py's device-time fallback on the card.

torch.profiler can miss a whole trace on the card.  `chip_smoke._device_ms`
then traces again and, where three traces saw nothing, reads a call's device
time from CUDA events (`_queued_ms`).  This forces that fallback with a
kernel name no trace holds and prints it beside the profiler's figure, for
K2 (`pallas_chol`) and `cholesky_ex` at B x n = 16 x 256, 64 x 1 and 1 x 1.
A call that waits for the card (`cholesky_ex`) is timed between two events
and says so.  Needs a card and nvcc:

    python3 tools/profiler_fallback.py
"""
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
from onephase_tpu_torch.ops import cholesky as ch  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_fallback: no CUDA device", file=sys.stderr)
        return 1
    around = cs._time_ms

    def noisy(fn):
        print("  (the call waits for the card: events around each call)")
        return around(fn)

    cs._time_ms = noisy
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for B, n in ((16, 256), (64, 1), (1, 1)):
        Q = cs._spd(rng, B, n, torch.float32, dev)
        for label, fn, name in (
                ("cholesky_ex", lambda Q=Q: torch.linalg.cholesky_ex(Q),
                 "aten::linalg_cholesky_ex"),
                ("pallas_chol", lambda Q=Q: ch.pallas_chol(Q),
                 "chol_kernel")):
            prof = cs._device_ms(fn, name)
            ev = cs._device_ms(fn, "no_such_kernel")
            print(f"{label} B={B} n={n}: profiler {prof:.4f} ms, events "
                  f"fallback {ev:.4f} ms", flush=True)
    print(cs._card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
