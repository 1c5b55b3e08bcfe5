"""The f32 outer step's segments as CUDA graphs, with ``tcg_step`` launched
between replays.

Within one chunk of the f32 phase on a whole ``DenseQ``, or on a whole
``SchurQ`` whose products take the fused kernels (the route that
``trust_region.graph_route`` picks), the shapes are fixed, and the step
works on static buffers: the frames, the scales, the carried ``2 Q sR``, the
fused loop's arrays and its scalar carry.  Each stretch of device work
between two host reads is captured once and replayed at every outer step:

* ``start``: ``trust_region._step_start`` (gradient, projection, norm),
  ``trust_region._build_minv`` and ``fused_tcg.prepare_arrays``, the norm
  copied into the loop's ``cfg``; then the host reads the norm;
* ``product``, the split variant's only: ``fused_tcg.split_product``
  before each ``tcg_step`` launch (the dense variant launches
  ``tcg_step_dense`` alone);
* ``end``: ``fused_tcg.loop_result`` and ``trust_region._step_end``; then
  the host reads the two losses;
* ``accept``: a kept step's frames, scales and ``2 Q sR`` into the state
  buffers.

``tcg_step`` and ``tcg_step_dense`` stay outside the graphs: every launch
goes through its wrapper, one call a launch, and the loop through
``fused_tcg.inner_tcg_fused``.  :class:`PhaseGraphs` is the second of
``trust_region._outer_step``'s two segment providers, beside
``trust_region.EagerSegments``: the step's host reads, checks, spans and
scalar logic are that function's alone, and the segments are the functions
the eager provider calls, so a replay runs the eager step's kernels on the
eager step's data and gives its bits.  On the CPU the segments run eagerly
on the same buffers (the tests' mirror of the route).

The graphs hold the pointer of the f32 operator, which every solve casts
anew, so they live for one chunk: each is captured at its first use and all
are released by :meth:`PhaseGraphs.close`.  What they allocate comes from
one memory pool a card, and the captures run on one stream a card; both stay
with the process, so a chunk's captures take the blocks the last chunk's
graphs freed instead of new ones from cudaMalloc, and the stream's cuBLAS
workspace is made once.  The segments share the pool safely because they
replay in the order they were captured, and what a segment keeps (its
outputs) is read before the segments captured before it replay again.  A
segment's first capture on a card for an operator class follows one eager
run of it on that stream, which makes the libraries' handles and
workspaces outside the capture.  :data:`utils.timer.graph_replays` counts
the replays.

The solve's counts live in Python (``utils.timer.counts``: its counters,
such as the implicit operator's ``applies_*``, and the kernel launchers'
``launches``), where a replay does not go.  So a capture records what its
capture run added to each count, and leaves every count as the warm-up and
the capture found them: the capture runs nothing on the card, and the
warm-up is the graph's, not the solve's.  Each replay adds what its capture
recorded, and the products among them (``utils.timer.PRODUCTS``) to
``utils.timer.applies_replayed``.  The ``product`` segment's replay runs in
the operator's ``apply_span``, where it has one (``SchurQ``'s
``xm.schurq.apply``), as an eager product does.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import NamedTuple

import torch

from xmtpu_torch.ops import fused_tcg
from xmtpu_torch.solver import trust_region as tr
from xmtpu_torch.utils.timer import (PRODUCTS, applies_replayed, counts,
                                     graph_replays, set_counts, span)


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    return torch.cuda.Stream(device)


@functools.lru_cache(maxsize=None)
def _pool(device: torch.device) -> tuple:
    """``(keeper, pool)``: the process's graph memory pool on ``device``,
    kept live by a graph of one fill that is never replayed.  A pool whose
    graphs are all gone cannot be captured into again (the caching
    allocators assert it), and a new pool a chunk takes new memory from the
    card (cudaMalloc) while the old one's stays reserved."""
    pool = torch.cuda.graph_pool_handle()
    keeper = torch.cuda.CUDAGraph()
    with torch.cuda.stream(_capture_stream(device)):
        keeper.capture_begin(pool=pool)
        try:
            torch.empty(1, device=device).zero_()
        finally:
            keeper.capture_end()
    return keeper, pool


# (device, operator class, segment) captured once already in this process
_warm = set()


def _moved(before: dict, after: dict) -> dict:
    """The counts that moved from ``before`` to ``after``, by how much."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


class _Segment(NamedTuple):
    """A captured segment: its graph, what its capture run added to each
    count (keyed as ``utils.timer.counts``: what each replay adds), and the
    products among them."""
    graph: "torch.cuda.CUDAGraph"
    counts: dict
    products: int


class PhaseGraphs:
    """One chunk's outer-step segments on static buffers, each captured
    once and replayed (see the module's docstring): the provider
    ``trust_region._outer_step`` takes on ``graph_route``'s route.  ``lam``
    is the host scalar of the working dtype."""

    def __init__(self, qop, st: tr.TRState, lam, cfg: tr.TRConfig):
        dev = st.R.device
        self.kind = type(qop)
        self.qmul = qop.apply
        self.apply_span = qop.apply_span
        self.Cdiag = qop.diag_blocks()
        self.lam, self.lam_f, self.cfg = lam, float(lam), cfg
        self.capture = dev.type == "cuda"
        # the state buffers: copies, since the chunk's state may alias a
        # caller's tensors
        self.R, self.s_ex = st.R.clone(), st.s_ex.clone()
        self.QsR = st.QsR.clone()
        self.cfgsc = fused_tcg.config_carry(lam, 0.0, 0.0, cfg.rdotr_min, dev)
        self.graphs = {}
        self.capture_s = 0.0       # host seconds of warm-ups and captures
        self.loop = self.grad = self.args = self.out = None

    # ---- the segments: device work only, nothing read back
    def _start(self):
        grad = tr._step_start(self.qmul, self.R, self.s_ex, self.QsR,
                              self.lam_f)
        CsR, egR, egs, pgR, pgs, gn = grad
        minv = tr._build_minv(self.Cdiag, self.s_ex, self.lam)
        const, state, sc = fused_tcg.prepare_arrays(
            self.R, self.s_ex, CsR, egR, egs, pgR, pgs, minv)
        self.cfgsc[fused_tcg.C_GNORM].copy_(gn)
        self.grad = grad
        self.args = tuple(const.values()) + state + (sc, self.cfgsc)

    def _product(self):
        fused_tcg.split_product(self.qmul, self.args)

    def _end(self):
        vR, vs, hvR, hvs = fused_tcg.loop_result(self.args, self.R.dtype)
        pgR, pgs = self.grad[3:5]
        self.out = tr._step_end(self.qmul, self.R, self.s_ex, vR, vs, hvR,
                                hvs, pgR, pgs, self.lam_f)

    def _accept(self):
        _, _, R_new, s_ex_new, dfdsR_new = self.out
        self.R.copy_(R_new)
        self.s_ex.copy_(s_ex_new)
        self.QsR.copy_(dfdsR_new)

    # ---- capture and replay
    def _run(self, name: str, opens: "str | None" = None) -> None:
        """The segment ``name``, replayed in the span ``opens`` if given."""
        fn = getattr(self, "_" + name)
        if not self.capture:
            fn()
            return
        seg = self.graphs.get(name)
        if seg is None:
            seg = self.graphs[name] = self._capture(name, fn)
        with span(opens) if opens else contextlib.nullcontext():
            seg.graph.replay()
        set_counts(seg.counts, add=True)
        applies_replayed.n += seg.products
        graph_replays.n += 1

    def _capture(self, name: str, fn) -> _Segment:
        """The segment ``fn`` captured (:meth:`_graph`) with what its
        capture run added to each count; every count ends as it was."""
        t0 = time.perf_counter()
        before = counts()
        try:
            graph, made = self._graph(name, fn)
        finally:
            set_counts(before)
        self.capture_s += time.perf_counter() - t0
        return _Segment(graph, made, sum(made.get(c, 0) for c in PRODUCTS))

    def _graph(self, name: str, fn) -> tuple:
        """``fn`` captured on the card's capture stream into the segment's
        pool, after an eager run there the first time in the process for
        the operator's class (the graph then holds the buffers that capture
        allocated: ``fn`` keeps them as attributes).  Returns the graph and
        the counts that the capture run moved, by how much."""
        dev = self.R.device
        cur, stream = torch.cuda.current_stream(dev), _capture_stream(dev)
        stream.wait_stream(cur)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            if (dev, self.kind, name) not in _warm:
                fn()
                _warm.add((dev, self.kind, name))
            warm = counts()
            g.capture_begin(pool=_pool(dev)[1])
            try:
                fn()
            finally:
                g.capture_end()
        cur.wait_stream(stream)
        return g, _moved(warm, counts())

    # ---- the provider's segments, as trust_region._outer_step calls them
    def state(self, st: tr.TRState) -> tr.TRState:
        return st._replace(R=self.R, s_ex=self.s_ex, QsR=self.QsR)

    def start(self, st: tr.TRState):
        self._run("start")
        return self.grad

    def tcg(self, st: tr.TRState, grad, gradnorm):
        self.cfgsc[fused_tcg.C_DELTA].fill_(float(st.delta))
        if self.loop is None or not self.capture:
            self.loop = fused_tcg.bind_loop(
                self.qmul, self.args,
                product=functools.partial(self._run, "product",
                                          self.apply_span))
        return fused_tcg.inner_tcg_fused(
            self.qmul, self.R, self.s_ex, *grad[:5], gradnorm, st.delta,
            self.lam, self.cfg, None, self.loop)

    def end(self, st: tr.TRState, grad, v):
        """The two losses, then the state buffers that :meth:`accept`
        fills; the segment ``_end`` reads the loop's result from the
        loop's arguments, not from ``v``."""
        self._run("end")
        return self.out[:2] + (self.R, self.s_ex, self.QsR)

    def accept(self) -> None:
        self._run("accept")

    def close(self) -> None:
        """Releases the graphs and every buffer they allocated; the state
        buffers stay with the states that hold them."""
        self.graphs.clear()
        self.loop = self.grad = self.args = self.out = None
