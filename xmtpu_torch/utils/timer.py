"""Lightweight phase timers (the reference's std::chrono spans,
trustregion.h:451,712-714) plus a ``torch.profiler`` trace hook: the port's
copy of ``xmtpu/utils/timer.py``, whose ``device_trace`` wraps
``jax.profiler``."""

from __future__ import annotations

import contextlib
import os
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


@contextlib.contextmanager
def device_trace(logdir: str):
    """``torch.profiler`` trace of the enclosed work, written as a Chrome
    trace (``chrome://tracing``, Perfetto) under ``logdir``: host activity,
    and the card's kernels and copies when a CUDA card is present.  Yields
    the trace file's path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
