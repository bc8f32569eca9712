"""Hierarchical named-span wall-clock timer.

Reference: the external `advanced_timer` package (ohinder) —
`class_advanced_timer`, `start/pause_advanced_timer(timer, "A/b")`,
`print_timer_stats`, `merge_timers` (used throughout, e.g.
src/IPM/one_phase.jl:28-52, benchmark/CUTEst/run_cutest.jl:130,181).

The timer measures host-side phases (init/chunks).  PyTorch dispatch is
asynchronous on CUDA, so a span only covers device work that a host read
inside it waited for; per-kernel device time comes from `torch.profiler`
or CUDA events instead.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class Timer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._stack = []

    @contextmanager
    def span(self, name: str):
        full = "/".join([*self._stack, name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._stack.pop()
            self.totals[full] += dt
            self.counts[full] += 1

    def merge(self, other: "Timer") -> "Timer":
        """A timer holding the sum of both timers' spans (the campaign
        harness's master timer)."""
        out = Timer()
        for src in (self, other):
            for k, v in src.totals.items():
                out.totals[k] += v
            for k, v in src.counts.items():
                out.counts[k] += v
        return out

    def stats(self) -> str:
        lines = ["SPAN\tTOTAL_S\tCOUNT"]
        for k in sorted(self.totals):
            lines.append(f"{k:<40}\t{self.totals[k]:.4f}\t{self.counts[k]}")
        return "\n".join(lines)

    def print_stats(self):
        print(self.stats())
