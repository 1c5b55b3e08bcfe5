"""Accumulating wall-clock phase timers (a copy of
``xmtpu.utils.timer.PhaseTimer``; the reference's ``jax.profiler`` hook has
no counterpart here — ``torch.profiler`` is used directly)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class PhaseTimer:
    """Accumulating wall-clock spans per named phase."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{k}: {v * 1e3:.2f} ms ({self.counts[k]}x)"
                 for k, v in sorted(self.totals.items())]
        return "\n".join(lines)
