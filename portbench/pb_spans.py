"""The traced window's idle time by the program's own spans.

``xmtpu_torch`` names its layers in a recording profiler with host ranges
under ``xm.`` (``xmtpu_torch/utils/timer.py``): ``xm.solve`` and
``xm.stage`` (the staircase), ``xm.tr.*`` (the trust region), ``xm.cert``
(the certificate), ``xm.recover`` (recovery).  Each idle nanosecond of the
window, where no device event runs (the complement of the union
``pb_trace.busy_ns`` sums), goes to the innermost ``xm.`` span open on the
window's thread at that moment, by exact interval arithmetic; the rest is
idle in no ``xm.`` span.  The layers and that rest partition the idle time.
A program without the spans gives none, and its readers read nothing.
"""

from __future__ import annotations

import json
from collections import defaultdict

PREFIX = "xm."
# a layer: the span names whose innermost idle time is its own
LAYERS = {"trust_region": lambda n: n.startswith("xm.tr."),
          "certificate": lambda n: n == "xm.cert",
          "recover": lambda n: n == "xm.recover",
          "staircase": lambda n: n in ("xm.solve", "xm.stage")}
NONE = "none"     # idle in no xm. span


def layer_of(name: str) -> str:
    for layer, match in LAYERS.items():
        if match(name):
            return layer
    return name   # an xm. span of no layer above: its own line


def idle_intervals(trace) -> list:
    """The window's idle intervals ``(a, b)``, in order."""
    out, end = [], trace.w0
    for _, s, d in trace.device:
        if s > end:
            out.append((end, s))
        end = max(end, s + d)
    if trace.w1 > end:
        out.append((end, trace.w1))
    return out


def innermost(spans) -> list:
    """``spans`` ``(name, start, end)`` of one thread, which nest, cut into
    pieces ``(a, b, name)`` in order: in ``[a, b)`` the innermost open span
    is ``name``.  Time under no span is in no piece."""
    out, stack, t = [], [], 0
    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][1] <= s:
            t = _emit(out, t, *stack.pop())
        if stack:
            t = _emit(out, t, stack[-1][0], s)
        t = max(t, s)
        stack.append((name, e))
    while stack:
        t = _emit(out, t, *stack.pop())
    return out


def _emit(out, t, name, b) -> int:
    if b > t:
        out.append((t, b, name))
        return b
    return t


def _overlaps(idle, pieces) -> list:
    """Each piece's ``(a, b, _)`` nanoseconds inside the intervals
    ``idle``; both in order, neither overlapping itself."""
    out = [0] * len(pieces)
    i = j = 0
    while i < len(idle) and j < len(pieces):
        a = max(idle[i][0], pieces[j][0])
        b = min(idle[i][1], pieces[j][1])
        if b > a:
            out[j] += b - a
        if idle[i][1] <= pieces[j][1]:
            i += 1
        else:
            j += 1
    return out


def _name(event) -> str:
    return event if isinstance(event, str) else event.name()


def split(run) -> "dict | None":
    """``{"idle": {layer or NONE: ns}, "spans": {name: [count, ns]},
    "window_ns": ...}`` of the run's trace, computed once a run; None
    without a trace."""
    trace = run.trace
    if trace is None or trace.w1 <= trace.w0:
        return None
    cached = getattr(run, "_pb_spans", None)
    if cached is not None:
        return cached
    spans, totals = [], defaultdict(lambda: [0, 0])
    for ev, s, e in trace.host:
        name = _name(ev)
        if name.startswith(PREFIX):
            spans.append((name, max(s, trace.w0), min(e, trace.w1)))
            totals[name][0] += 1
            totals[name][1] += e - s
    idle = idle_intervals(trace)
    pieces = innermost(spans)
    by = defaultdict(int)
    for (_, _, name), ns in zip(pieces, _overlaps(idle, pieces)):
        by[layer_of(name)] += ns
    gaps, prev = [], trace.w0
    for a, b, _ in pieces:
        if a > prev:
            gaps.append((prev, a, NONE))
        prev = max(prev, b)
    gaps.append((prev, trace.w1, NONE))
    by[NONE] = sum(_overlaps(idle, gaps))
    out = {"idle": dict(by), "spans": dict(totals),
           "window_ns": trace.w1 - trace.w0}
    run._pb_spans = out
    print("[portbench] idle ns by xm. layer " + json.dumps(out["idle"])
          + " of a window of " + json.dumps(out["window_ns"])
          + " ns; xm. spans [count, ns] " + json.dumps(out["spans"]),
          flush=True)
    return out


def idle_pct(run, layer: str) -> "float | None":
    """Percent of the traced window idle under ``layer``'s spans; None
    without a trace or without any span of the layer in it."""
    sp = split(run)
    if sp is None or not any(LAYERS[layer](n) for n in sp["spans"]):
        return None
    return 100.0 * sp["idle"].get(layer, 0) / sp["window_ns"]


def results(sol) -> tuple:
    """Every ``SolveResult`` a served request ran, in order
    (``pb_program.Solution.results``), so that a request of several solves
    counts whole; a record that holds only ``result`` gives that one."""
    if hasattr(sol, "results"):
        return tuple(sol.results)
    return () if sol.result is None else (sol.result,)


def stage_counters(run, key: str) -> list:
    """The ``SolveResult.stages`` entries of every solve of the traced
    requests that carry ``key`` (a program without the counter gives
    none)."""
    return [st for s in run.traced for r in results(s) for st in r.stages
            if key in st]
