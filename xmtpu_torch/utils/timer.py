"""Phase timers, spans on the profiler's clock, the solve path's counters
and a ``torch.profiler`` trace hook: the port's copy of
``xmtpu/utils/timer.py`` (the reference's std::chrono spans,
trustregion.h:451,712-714), whose ``device_trace`` wraps ``jax.profiler``.

Spans.  :func:`span` names a stretch of the host thread's work.  While a
``torch.profiler`` session records (``device_trace``, or any
``torch.profiler.profile``), it is a FUNCTION-scope range: a host event of
the trace, on the device events' clock, with no device-side twin (a
USER-scope ``record_function`` range gets one).  Otherwise it is one flag
check and a shared no-op context.  The solve path's spans, each enclosing
the next where they nest:

* ``xm.solve``: ``solver/staircase.solve_arrays``, the whole call;
* ``xm.stage``: one rank of the staircase, through its certificate (the
  interval of that rank's ``stage_s + cert_s``);
* ``xm.tr.escape``: the saddle-escape line search;
* ``xm.tr.chunk.f32`` / ``xm.tr.chunk.f64``: a chunk of outer trust-region
  iterations in that working dtype;
* ``xm.tr.tcg``: one truncated-CG solve (inside a chunk);
* ``xm.cert``: the dual certificate (the interval of ``cert_s``);
* ``xm.schurq.apply``: one product of the implicit operator
  (``ops/schurq.py``: ``SchurQ.apply``, which ``SchurQEdgeF32`` and the
  sharded operator share, and ``SchurQTF.apply``), inside a trust-region
  span, the certificate's, or a stage's own reads of the loss;
* ``xm.recover``: ``pipeline/recover.recover_XM`` / ``recover_XM_implicit``,
  a leaf: no span opens inside it.

Around the solve, XM^2's two passes (``pipeline/xm2.py``): ``xm.xm2``, the
whole of ``xm2_solve``; ``xm.xm2.host``, each of its host stages over the
observations (``checklandmarks``, the residuals and the percentile cut);
``xm.schurq.build``, ``ops/schurq.SchurQ.build``.

Counters.  :data:`host_reads` counts the device-to-host reads of the trust
region's control loop (``solver/trust_region._fetch``,
``ops/fused_tcg._read_carry``), :data:`graph_replays` the replays of its
captured CUDA graphs (``solver/graph_step.py``), :data:`f32_nonfinite` the
mixed ladder's f32 phases ended at a non-finite reading
(``solver/trust_region._nonfinite``), :data:`applies_f64`,
:data:`applies_tf` and :data:`applies_f32` the implicit operator's
products: the exact ``SchurQ`` in float64, the two-float ``SchurQTF``, and
those in float32 arithmetic (``SchurQEdgeF32``'s edge sums, ``SchurQ``
cast to float32), :data:`applies_fused` those of the float32 ones that
ran as the fused kernels (``ops/schurq.schurq_product`` on a card), and
:data:`applies_replayed` those of all three that ran inside a replayed
CUDA graph (``solver/graph_step.py``), :data:`inner_replayed` the float64
tCG's inner iterations that ran inside a replayed loop graph and
:data:`inner_masked` those that a replay ran past the loop's stop
(``graph_step.InnerGraphs``).  All only grow, and a reader takes
the difference over the stretch it measures.  :data:`COUNTERS` lists
them, and :func:`launcher` enters the kernel launchers of ``ops/``, each of
which counts its calls in its attribute ``launches``, in
:data:`LAUNCHERS`: :func:`counts` reads all of these counts and
:func:`set_counts` sets or adds to them, as ``solver/graph_step.py`` does
around a graph's capture and at each replay.  :func:`memory_allocated` and
:func:`max_memory_allocated` read the card's allocator while spans are on.
``solve_arrays`` puts the counts and readings, per rank, into
``SolveResult.stages``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context naming the enclosed host work ``name`` in a profiler trace
    that is recording, else (or inside a leaf span) the shared no-op
    context."""
    if not _autograd_profiler._is_profiler_enabled or _leaves.n:
        return _OFF
    return _RecordFunctionFast(name)


def spanned(name: str, leaf: bool = False):
    """Decorator: each call of the function inside ``span(name)``; with
    ``leaf``, no span opens inside the call."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                if not leaf:
                    return fn(*args, **kwargs)
                _leaves.n += 1
                try:
                    return fn(*args, **kwargs)
                finally:
                    _leaves.n -= 1
        return call
    return wrap


# every ReadCounter below, but the depth _leaves, in order of definition
COUNTERS = []


class ReadCounter:
    """A count: ``n``, the events counted so far (the counters below only
    grow; ``_leaves`` is a depth), entered in :data:`COUNTERS` if
    ``listed``."""

    __slots__ = ("n",)

    def __init__(self, listed: bool = True):
        self.n = 0
        if listed:
            COUNTERS.append(self)


# the trust region's device-to-host reads (each one also a synchronise)
host_reads = ReadCounter()
# replays of the trust region's captured CUDA graphs (solver/graph_step.py)
graph_replays = ReadCounter()
# f32 phases of the mixed ladder ended at a non-finite loss, gradient norm
# or radius (solver/trust_region.py)
f32_nonfinite = ReadCounter()
# the implicit operator's products (ops/schurq.py): exact float64, two-float,
# float32 arithmetic
applies_f64 = ReadCounter()
applies_tf = ReadCounter()
applies_f32 = ReadCounter()
# the float32 products among them that ran as the fused kernels
# (ops/schurq.py schurq_product)
applies_fused = ReadCounter()
# the products among them that ran by graph replay (solver/graph_step.py)
applies_replayed = ReadCounter()
# the float64 tCG's inner iterations that ran inside a replayed loop graph,
# and those that a replay ran past the loop's stop, every carried value
# kept (solver/graph_step.py InnerGraphs)
inner_replayed = ReadCounter()
inner_masked = ReadCounter()
# the depth of open leaf spans (spanned(..., leaf=True)): no span opens
# inside one
_leaves = ReadCounter(listed=False)
# the three that partition the implicit operator's products
PRODUCTS = (applies_f64, applies_tf, applies_f32)

# the kernel launchers of ops/ (launcher), by module and name
LAUNCHERS = []


def launcher(fn):
    """Decorator: ``fn`` launches a kernel and counts its calls on the card
    in its attribute ``launches``, from 0; entered in :data:`LAUNCHERS`."""
    fn.launches = 0
    LAUNCHERS.append((fn.__module__, fn.__name__))
    return fn


def _launcher(key):
    """A launcher as its callers find it: through its module, where a
    caller may have put a wrapper that carries its count."""
    module, name = key
    return getattr(sys.modules[module], name)


def counts() -> dict:
    """Every count: each of :data:`COUNTERS` by itself, and each launcher's
    ``launches`` by its key in :data:`LAUNCHERS`."""
    out = {c: c.n for c in COUNTERS}
    for key in LAUNCHERS:
        out[key] = _launcher(key).launches
    return out


def set_counts(values: dict, add: bool = False) -> None:
    """Each count that ``values`` (keyed as :func:`counts`) names set to
    its value there, or, with ``add``, grown by it."""
    for key, v in values.items():
        if isinstance(key, ReadCounter):
            key.n = key.n + v if add else v
        else:
            fn = _launcher(key)
            fn.launches = fn.launches + v if add else v


def _card(device) -> bool:
    return (_autograd_profiler._is_profiler_enabled
            and torch.device(device).type == "cuda")


def memory_allocated(device) -> "int | None":
    """Bytes the allocator holds on the card ``device`` while spans are on;
    None otherwise (spans off, or a host device)."""
    return torch.cuda.memory_allocated(device) if _card(device) else None


def max_memory_allocated(device) -> "int | None":
    """The card's peak allocated bytes since its peak statistics were last
    reset (the program never resets them), while spans are on; None
    otherwise."""
    return torch.cuda.max_memory_allocated(device) if _card(device) else None


class PhaseTimer:
    """Accumulating wall-clock spans per named phase.  Each phase is also a
    :func:`span` of its name, and ends with a synchronise of the card once
    CUDA is initialised, so that a phase's queued device work counts in it
    and not in the next one."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
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
    trace (``chrome://tracing``, Perfetto) under ``logdir``: host activity
    with the solve path's ``xm.*`` spans, and the card's kernels and copies
    when a CUDA card is present.  Yields the trace file's path."""
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
