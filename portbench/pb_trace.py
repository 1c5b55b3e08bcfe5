"""The traced window: ``torch.profiler`` around the measured solutions, and
its reduction to what the per-layer readers take.

Once a process has worked the card a while the profiler drops the first
device events of a window, never the last.  So, as the repository's
``chip_smoke.traced()`` does, the window opens with ``TRACE_PAD`` launches
of ATen's spin kernel, which are left out of the events.  Where none of
them was kept, real events may have been lost as well, and the run fails
instead of reporting (:class:`TraceLost`).  The window itself is the span
of a ``pb.window`` annotation around the solutions.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple

TRACE_PAD = 1024
# the traced part of a window: its first whole cycles past this many
# seconds of it (the profiler's stop and the events' read take ~3 s for
# each second traced)
TRACE_SECONDS = 15.0
SPIN = "spin_kernel"
WINDOW = "pb.window"


class TraceLost(RuntimeError):
    pass


class Trace(NamedTuple):
    """Device events ``(name, start_ns, dur_ns)`` in start order, the
    window's host thread's events ``(event, start_ns, end_ns)`` in start
    order (``event.name()`` read only where needed), and the window ``[w0,
    w1]`` in the trace's clock."""

    device: list
    host: list
    w0: int
    w1: int

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9


def traced(fn):
    """``fn()`` under the profiler, its result and the :class:`Trace`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_PAD):
            torch.cuda._sleep(1)
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()

    device, host_ev, pads = [], [], 0
    window = None
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            name = e.name()
            if SPIN in name:
                pads += 1
            elif name != WINDOW:        # the annotation's device-side twin
                device.append((name, e.start_ns(), e.duration_ns()))
        else:
            host_ev.append(e)
    if pads == 0:
        raise TraceLost(f"the profiler kept none of the {TRACE_PAD} launches "
                        "opening the traced window: its first real events "
                        "may be lost too")
    for e in host_ev:
        if e.name() == WINDOW:
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
            tid = e.start_thread_id()
            break
    else:
        raise TraceLost(f"the profiler lost the {WINDOW} annotation")
    host = sorted(((e, e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in host_ev if e.start_thread_id() == tid),
                  key=lambda h: h[1])
    device.sort(key=lambda d: d[1])
    w0, w1 = window
    device = [d for d in device if d[1] >= w0 and d[1] + d[2] <= w1]
    return out, Trace(device, host, w0, w1)


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def busy_ns(trace: Trace) -> int:
    """Nanoseconds of the window in which some device event ran (the union
    of their intervals)."""
    busy, end = 0, trace.w0
    for _, s, d in trace.device:
        a, b = max(s, end), s + d
        if b > a:
            busy += b - a
            end = b
    return busy


def kernel_ns(trace: Trace, match) -> "tuple[int, int]":
    """``(count, summed ns)`` of the device events whose name ``match``
    accepts."""
    n = t = 0
    for name, _, d in trace.device:
        if match(name):
            n += 1
            t += d
    return n, t


def top_device_ops(trace: Trace, k: int = 10) -> list:
    tot = defaultdict(int)
    for name, _, d in trace.device:
        tot[name] += d
    return [[name, ns / 1e9] for name, ns in
            sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def idle_by_host(trace: Trace, k: int = 10) -> list:
    """The window's idle time, gap by gap between device events, summed by
    the innermost host event running at each gap's middle (``host: python,
    no op`` where only the window's annotation was)."""
    starts = [h[1] for h in trace.host]
    ends = [h[2] for h in trace.host]
    parent = _parents(starts, ends)
    gaps = defaultdict(int)
    end = trace.w0
    bounds = [(s, s + d) for _, s, d in trace.device] + [(trace.w1, trace.w1)]
    for s, e in bounds:
        if s > end:
            mid = (s + end) // 2
            j = bisect.bisect_right(starts, mid) - 1
            while j >= 0 and ends[j] < mid:
                j = parent[j]
            gaps[j] += s - end
        end = max(end, e)
    named = defaultdict(int)
    for j, ns in gaps.items():
        named[_name(trace.host[j][0]) if j >= 0 else "host: none"] += ns
    return [[name, ns / 1e9] for name, ns in
            sorted(named.items(), key=lambda kv: -kv[1])[:k]]


def _parents(starts, ends) -> list:
    """Each host event's enclosing event (-1 for none): events of one thread
    nest, so a sweep in start order with a stack of the open ones finds
    them; the innermost event open at a time is then the last one started
    before it, or the nearest of its ancestors still open."""
    parent, stack = [], []
    for s, e in zip(starts, ends):
        while stack and ends[stack[-1]] < s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(len(parent) - 1)
    return parent


def _name(event) -> str:
    name = event if isinstance(event, str) else event.name()
    # inside the window but in no operator: the host's own Python
    return "host: python, no op" if name == WINDOW else name
