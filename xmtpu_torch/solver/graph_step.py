"""The f32 outer step's segments as CUDA graphs, with ``tcg_step`` launched
between replays; and the f64 tCG on device scalars as CUDA graphs.

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

:class:`InnerGraphs` is the f64 tCG's provider on
``trust_region.tcg_graph_route``'s route (an f64 carry whose tCG products
take a ``capturable`` f32 operator: the ``inner_f32`` products of the f64
ladder), which ``trust_region.EagerSegments.tcg`` takes in place of the
same loop run eagerly (``_inner_tcg``); the outer step's segments stay
eager.  It works on static buffers of one chunk (the solve's inputs,
copied in, and the loop's carry, ``trust_region.TCGCarry``) in two
segments:

* ``open``: the preconditioner (``trust_region._build_minv``) and the
  loop's preamble (``trust_region._tcg_open``) into the carry;
* ``loop``: one iteration (``trust_region._tcg_body``), the carry advanced
  in place, its control in one small buffer (``TCGCarry.flags``);

the host replays ``open``, then ``loop`` ``fused_tcg.FLAG_EVERY`` times
and one read of that buffer (``fused_tcg.until_done``), until the loop is
done or has run ``max_inner`` iterations.  A graph of one iteration
takes a quarter of the capture of ``FLAG_EVERY`` iterations, which a
short tCG (a dense f64 polish of a dozen iterations) does not win back,
and its in-place carry needs no copy at its end.  An iteration past the
stop keeps every carried value, so the result does not depend on
``FLAG_EVERY``.  The products replay inside the ``xm.tr.tcg``
span, with no span of their own.
:data:`utils.timer.inner_replayed` counts the iterations that ran inside a
replayed ``loop`` and :data:`utils.timer.inner_masked` those that a replay
ran past the stop; a masked iteration's product is counted as the capture
counted it.
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
                                     graph_replays, inner_masked,
                                     inner_replayed, set_counts, span)


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


class _Captured:
    """Named segments of device work (the methods ``_<name>``), each
    captured once on the card ``device`` and replayed, or run eagerly on
    the host: the machinery of both providers.  ``kind`` (the operator's
    class) keys the warm-up rule."""

    def __init__(self, kind, device: torch.device):
        self.kind, self.device = kind, device
        self.capture = device.type == "cuda"
        self.graphs = {}
        self.capture_s = 0.0       # host seconds of warm-ups and captures

    def _segment(self, name: str) -> _Segment:
        """The segment ``name``, captured at its first use."""
        seg = self.graphs.get(name)
        if seg is None:
            seg = self.graphs[name] = self._capture(
                name, getattr(self, "_" + name))
        return seg

    def _run(self, name: str, opens: "str | None" = None) -> None:
        """The segment ``name``, replayed in the span ``opens`` if given."""
        if not self.capture:
            getattr(self, "_" + name)()
            return
        seg = self._segment(name)
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
        dev = self.device
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

    def close(self) -> None:
        """Releases the graphs; the buffers the segments keep as attributes
        go with the provider."""
        self.graphs.clear()


class PhaseGraphs(_Captured):
    """One chunk's outer-step segments on static buffers, each captured
    once and replayed (see the module's docstring): the provider
    ``trust_region._outer_step`` takes on ``graph_route``'s route.  ``lam``
    is the host scalar of the working dtype."""

    def __init__(self, qop, st: tr.TRState, lam, cfg: tr.TRConfig):
        dev = st.R.device
        super().__init__(type(qop), dev)
        self.qmul = qop.apply
        self.apply_span = qop.apply_span
        self.Cdiag = qop.diag_blocks()
        self.lam, self.lam_f, self.cfg = lam, float(lam), cfg
        # the state buffers: copies, since the chunk's state may alias a
        # caller's tensors
        self.R, self.s_ex = st.R.clone(), st.s_ex.clone()
        self.QsR = st.QsR.clone()
        self.cfgsc = fused_tcg.config_carry(lam, 0.0, 0.0, cfg.rdotr_min, dev)
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
        super().close()
        self.loop = self.grad = self.args = self.out = None


class InnerGraphs(_Captured):
    """One chunk's f64 tCG solves on device scalars, its two segments each
    captured once and replayed (see the module's docstring): the provider
    ``trust_region.EagerSegments.tcg`` takes on ``tcg_graph_route``'s
    route.  ``q32`` is the tCG's f32 operator, ``qmul`` its product in the
    working dtype (the cast, the product, the cast back), ``Cdiag`` the
    preconditioner's diagonal blocks, ``lam`` the host scalar of the
    working dtype.  ``fused_tcg.FLAG_EVERY``, as it reads at construction,
    sets the iterations between two reads."""

    def __init__(self, q32, qmul, Cdiag, st: tr.TRState, lam,
                 cfg: tr.TRConfig):
        R, s_ex = st.R, st.s_ex
        dev, dt = R.device, R.dtype
        super().__init__(type(q32), dev)
        self.qmul, self.Cdiag = qmul, Cdiag
        self.lam, self.lam_f, self.cfg = lam, float(lam), cfg
        self.every = fused_tcg.FLAG_EVERY
        s = s_ex[1:]
        # the inputs, copied in at each solve: R, s_ex and _step_start's
        # CsR, egR, egs, pgR, pgs
        self.ins = tuple(torch.zeros_like(t)
                         for t in (R, s_ex, R, R, s, R, s))
        zero = torch.zeros((), dtype=dt, device=dev)
        # delta * delta and gradnorm * min(gradnorm, 0.1), filled at each
        # solve; a 0.0
        self.dd, self.thr, self.zero = zero.clone(), zero.clone(), zero
        self.Segr = torch.zeros((R.shape[0], 3, 3), dtype=dt, device=dev)
        self.minv = (torch.zeros_like(self.Segr), torch.zeros_like(s))
        self.carry = tr.TCGCarry(
            *(torch.zeros_like(t) for t in (R, s) * 4),
            *(zero.clone() for _ in range(5)),
            torch.zeros((3,), dtype=torch.int64, device=dev))

    # ---- the segments: device work only, nothing read back
    def _open(self):
        R, s_ex, _, egR, _, pgR, pgs = self.ins
        minv = tr._build_minv(self.Cdiag, s_ex, self.lam)
        Segr, c = tr._tcg_open(R, s_ex, egR, pgR, pgs, minv)
        for dst, src in zip((self.Segr,) + self.minv + self.carry,
                            (Segr,) + minv + c):
            dst.copy_(src)

    def _loop(self):
        R, s_ex, CsR, egR, egs, _, _ = self.ins
        tr._tcg_body(self.qmul, R, s_ex, CsR, egR, egs, self.Segr, self.minv,
                     self.lam_f, self.dd, self.thr, self.zero, self.cfg,
                     self.carry)

    # ---- the provider's solve, as trust_region._inner_tcg returns
    def solve(self, st: tr.TRState, grad, gradnorm):
        """The tCG from the state ``st``, ``_step_start``'s ``grad`` and the
        host's ``gradnorm``: ``(vR, vs, hvR, hvs, endreason, iters)``, the
        vectors the carry's buffers (read before the next solve)."""
        for dst, src in zip(self.ins, (st.R, st.s_ex) + tuple(grad[:5])):
            dst.copy_(src)
        for dst, v in zip((self.dd, self.thr), tr._tcg_limits(
                tr.np_dtype(st.R.dtype), st.delta, gradnorm)):
            dst.fill_(float(v))
        if self.capture:
            # the loop's warm-up runs an iteration on the carry: both are
            # captured before the preamble's replay sets it
            self._segment("open")
            self._segment("loop")
        self._run("open")
        ran = 0

        def advance():
            nonlocal ran
            for _ in range(self.every):
                self._run("loop")
            ran += self.every

        read = fused_tcg.until_done(advance, self.carry.flags,
                                    self.cfg.max_inner, at=(tr.F_DONE, tr.F_I))
        i = int(read[tr.F_I])
        if self.capture:
            inner_replayed.n += i
            inner_masked.n += ran - i
        c = self.carry
        return c.vR, c.vs, c.hvR, c.hvs, int(read[tr.F_ER]), i
