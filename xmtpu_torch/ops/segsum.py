"""Sorted segment sums: hand-written CUDA kernels + plain twins.

Counterpart of ``xmtpu/ops/pallas_segsum.py``.  The implicit operator
(``ops/schurq.py``) reduces per-edge arrays into per-landmark and per-frame
sums over edges kept sorted by segment; the mapper's tail stages and the LM
refinement sum per-observation rows by image, track or frame
(:class:`Segments`).  Two kernels in ``xmtpu_torch/csrc/segsum.cu``:

* ``sorted_segment_sum`` replaces ``pallas_segsum._kernel``: a segmented
  reduction over CSR offsets, each segment's rows added in row order from
  zero (no float atomics, the bits of the CPU twin, the same bits every
  run).  Short segments: each output element's thread walks its segment's
  rows; :func:`csr_threads` sizes the blocks so that every SM gets some,
  and on narrow rows of short segments (:func:`csr_batch`) a thread loads
  ``CSR_BATCH`` rows before it adds any.  Long segments (more than
  ``CSR_LONG`` rows, listed by the offsets' host plan, :class:`CsrPlan`):
  a thread block each streams the segment's contiguous rows through a ring
  of ``LONG_STAGES`` shared-memory stages (of :func:`long_stage_bytes`,
  tiles of :func:`long_tile_rows` rows) while one thread a column adds them
  in row order; a layout holding both kinds is still one launch.
* ``sorted_segment_sum_blocked`` replaces ``pallas_segsum._kernel_blocked``:
  the same sum on the scheduled layout of :func:`plan_blocks` /
  :func:`schedule_edges`, in one pass: each thread block finds its tile of
  segments' rows from the visits' first ids and sums each run in row
  order.

The plain twin of both is ``torch.zeros(S, D).index_add_(0, ids, vals)``.
The host plan rides on the offsets tensor that :func:`planned_offsets`
makes from host integers (``Segments``, ``SchurQ.build``), as its
``csr_plan`` attribute: only that tensor object carries it, so offsets
computed on the card, moved, cut or padded never carry a stale plan, and
take the short-segment walk alone.  :class:`Segments` sums rows by ids that
need not be sorted (the scatters of the mapper's tail stages) through
``sorted_segment_sum``, over one stable permutation built once per solve.
Wrapper rule (as in ``ops/fused_tcg.py``): CPU tensors take the twin; CUDA
tensors launch the kernel (counted in the wrapper's ``launches``, and by
dtype and width in ``shapes``, by the plan's layout name in ``layouts``)
or raise.

The host helpers ``max_band``, ``plan_blocks``, ``schedule_edges``, ``CHUNK``
and ``SEG_BLOCK`` are copies of the reference's, so both packages schedule
the same layout.  The CUDA kernels need no band: ``band`` is kept in the
signatures so callers port unchanged.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from xmtpu_torch.ops.fused_tcg import _check, _on_cpu, _raise_on
from xmtpu_torch.utils.timer import launcher

CHUNK = 512
SEG_BLOCK = 2048

# sorted_segment_sum's launch geometry (see csr_threads, csr_batch): the
# block sizes it may take, largest first, the fewest blocks worth keeping
# (two for each of the H100's 132 SMs), and the rows a thread loads before
# it adds any on narrow rows of short segments (csrc/segsum.cu instantiates
# 1 and 16), with the bounds of "narrow" and "short"
CSR_THREADS = (256, 128, 64)
CSR_MIN_BLOCKS = 264
CSR_BATCH = 16
CSR_NARROW_D = 3
CSR_SHORT = 16

# the long-segment path (see CsrPlan): segments of more than CSR_LONG rows
# get a block of LONG_THREADS threads each, one adder a column (rows of at
# most LONG_MAX_D values), streaming their rows through a ring of
# LONG_STAGES stages (long_stage_bytes; csrc/segsum.cu's LONG_THREADS,
# LONG_STAGES and LONG_BATCH).  CSR_LONG was measured on the H100
# (PERF.md): at 64 the triangulation's track sums (longest 65 rows) took a
# few long blocks, whose ring cut the blocks an SM holds, and slowed from
# 0.0078 to 0.0136 ms; at 128 to 512 the tail's layouts take the same time
CSR_LONG = 128
LONG_THREADS = 128
LONG_MAX_D = LONG_THREADS
LONG_STAGES = 4
LONG_BATCH = 8      # rows an adder loads before it adds them (add_rows' U)
# bytes a ring stage holds for rows of at most LONG_WIDE_ROW bytes, and for
# wider rows, which need more bytes in flight a block (measured on the
# H100, PERF.md: 8 smaller stages were slower at every width)
LONG_STAGE_BYTES = 24576
LONG_WIDE_STAGE_BYTES = 32768
LONG_WIDE_ROW = 64


def max_band(seg_ids: np.ndarray, chunk: int = CHUNK) -> int:
    """Largest number of distinct segments spanned by any length-``chunk``
    window of the sorted ``seg_ids`` — the reference kernel's ``band``."""
    seg_ids = np.asarray(seg_ids)
    E = len(seg_ids)
    best = 1
    for start in range(0, E, chunk):
        w = seg_ids[start:start + chunk]
        best = max(best, int(w[-1] - w[0]) + 1)
    return best


def plan_blocks(seg_ids: np.ndarray, num_segments: int, chunk: int = CHUNK,
                seg_block: int = SEG_BLOCK):
    """Host-side schedule for :func:`sorted_segment_sum_blocked` (a copy of
    the reference's): split the sorted edge stream at output-block
    boundaries, re-chunk each block's span to ``chunk`` rows, and add one
    empty visit per edge-less block.

    Returns ``(gather_idx (G*chunk,), pad_mask (G*chunk,), blk (G,),
    first (G,), band)``.
    """
    seg_ids = np.asarray(seg_ids)
    E = len(seg_ids)
    nb = -(-num_segments // seg_block)
    blk_edge_start = np.searchsorted(
        seg_ids, np.arange(nb, dtype=np.int64) * seg_block)
    blk_edge_end = np.append(blk_edge_start[1:], E)
    spans, blks = [], []
    for b in range(nb):
        s, e = int(blk_edge_start[b]), int(blk_edge_end[b])
        if s == e:
            spans.append((s, s))          # empty visit: zero-init the block
            blks.append(b)
        else:
            for c0 in range(s, e, chunk):
                spans.append((c0, min(c0 + chunk, e)))
                blks.append(b)
    G = len(spans)
    s_arr = np.asarray([s for s, _ in spans], np.int64)
    e_arr = np.asarray([e for _, e in spans], np.int64)
    blk = np.asarray(blks, np.int32)
    first = np.ones(G, np.int32)
    first[1:] = (blk[1:] != blk[:-1]).astype(np.int32)
    gidx = s_arr[:, None] + np.arange(chunk, dtype=np.int64)[None, :]
    pad = gidx >= e_arr[:, None]
    gidx = np.clip(np.minimum(gidx, np.maximum(e_arr, 1)[:, None] - 1),
                   0, max(E - 1, 0))
    nonempty = e_arr > s_arr
    band = 1
    if nonempty.any():
        band = int((seg_ids[e_arr[nonempty] - 1]
                    - seg_ids[s_arr[nonempty]]).max()) + 1
    assert band <= seg_block
    return gidx.ravel(), pad.ravel(), blk, first, band


def schedule_edges(seg_ids: np.ndarray, num_segments: int,
                   chunk: int = CHUNK, seg_block: int = SEG_BLOCK):
    """Scheduled segment-id array + gather/pad plan for laying out per-edge
    payloads in the blocked layout.  Returns ``(ids_sched (G*chunk,), gidx,
    pad, blk, first, band)``."""
    seg_ids = np.asarray(seg_ids)
    gidx, pad, blk, first, band = plan_blocks(seg_ids, num_segments, chunk,
                                              seg_block)
    ids_sched = seg_ids[gidx] if len(seg_ids) else np.zeros_like(gidx)
    blk_first_per_row = np.repeat(blk.astype(np.int64) * seg_block, chunk)
    ids_sched = np.where(pad, blk_first_per_row, ids_sched).astype(np.int32)
    return ids_sched, gidx, pad, blk, first, band


def segment_offsets(seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(S+1,) int32 CSR offsets of sorted ``seg_ids``: rows
    ``[off[s], off[s+1])`` hold segment ``s`` (on the ids' device)."""
    ids = seg_ids.contiguous()
    keys = torch.arange(num_segments + 1, dtype=ids.dtype, device=ids.device)
    return torch.searchsorted(ids, keys).to(torch.int32)


class CsrPlan(NamedTuple):
    """Host plan of one CSR layout, built once from its host offsets (no
    device read): the ``n_long`` segments of more than ``long_rows`` rows as
    ``longs (n_long, 3)`` int32 rows (segment, first row, end row) on the
    device, longest first, so the longest chains start first; ``n_short``
    segments of at most ``long_rows`` rows (the empty ones included);
    ``rows`` E and ``segments`` S of the layout, checked at every call;
    ``layout`` names it in the wrapper's ``layouts`` count."""

    layout: str
    rows: int
    segments: int
    long_rows: int
    longs: torch.Tensor
    n_long: int
    n_short: int
    longest: int


def csr_plan(offsets, device, layout: str = "unnamed") -> CsrPlan:
    """The :class:`CsrPlan` of the host CSR ``offsets`` (S+1,), its long
    segments those of more than ``CSR_LONG`` rows."""
    off = np.asarray(offsets, dtype=np.int64)
    L = np.diff(off)
    seg = np.flatnonzero(L > CSR_LONG)
    seg = seg[np.argsort(-L[seg], kind="stable")]
    longs = np.stack([seg, off[seg], off[seg + 1]], axis=1).astype(np.int32)
    return CsrPlan(layout, int(off[-1]), len(L), CSR_LONG,
                   torch.as_tensor(longs, device=device), len(seg),
                   len(L) - len(seg), int(L.max(initial=0)))


def planned_offsets(offsets, device, layout: str = "unnamed") -> torch.Tensor:
    """The host CSR ``offsets`` (S+1,) as an int32 tensor on ``device``
    carrying their :class:`CsrPlan` as ``csr_plan``."""
    t = torch.as_tensor(np.asarray(offsets), dtype=torch.int32,
                        device=device)
    t.csr_plan = csr_plan(offsets, device, layout)
    return t


def long_stage_bytes(D: int, itemsize: int) -> int:
    """Bytes of one ring stage of the long-segment launch for rows of ``D``
    values of ``itemsize`` bytes."""
    return (LONG_WIDE_STAGE_BYTES if D * itemsize > LONG_WIDE_ROW
            else LONG_STAGE_BYTES)


def long_tile_rows(D: int, itemsize: int, stage_bytes: int) -> int:
    """Rows of one tile of a long segment: as many rows of ``D`` values of
    ``itemsize`` bytes as one ring stage of ``stage_bytes`` holds, a whole
    number of the adders' batches of ``LONG_BATCH`` rows where that is at
    least one."""
    rows = max(1, stage_bytes // (D * itemsize))
    return rows - rows % LONG_BATCH if rows >= LONG_BATCH else rows


def csr_threads(S: int, D: int) -> int:
    """Threads of a ``sorted_segment_sum`` block at ``S * D`` outputs (one
    thread each): the largest of ``CSR_THREADS`` that still makes
    ``CSR_MIN_BLOCKS`` blocks, else the smallest."""
    outs = S * D
    return next((t for t in CSR_THREADS if -(-outs // t) >= CSR_MIN_BLOCKS),
                CSR_THREADS[-1])


def csr_batch(E: int, S: int, D: int) -> int:
    """Rows a ``sorted_segment_sum`` thread loads before it adds any:
    ``CSR_BATCH`` on rows of at most ``CSR_NARROW_D`` values in segments of
    at most ``CSR_SHORT`` rows on average (``E / S``: a host integer, no
    sync), where a warp's loads spread over ~32/D segments and the launch
    waits for its longest chain of round trips; else 1, the row-by-row loop
    the compiler unrolls (measured faster on wider rows, which coalesce
    across d, and on longer segments)."""
    return CSR_BATCH if D <= CSR_NARROW_D and E <= CSR_SHORT * S else 1


# ------------------------------------------------------ plain version --

def sorted_segment_sum_plain(vals: torch.Tensor, seg_ids: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """Plain twin of both kernels: ``(S, D)`` sums of the rows of ``vals``
    by ``seg_ids`` through ``index_add_`` (in row order on the CPU, by
    atomics on CUDA)."""
    out = torch.zeros((num_segments,) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg_ids.to(torch.int64), vals)


# ------------------------------------------------------------ wrappers --

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    from xmtpu_torch import _build

    lib = _build.load("segsum")
    if not getattr(lib, "_xm_typed", False):
        for name in ("xm_segsum_f32", "xm_segsum_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 3 + [_I] * 4 + [_P]
            fn.restype = _I
        for name in ("xm_segsum_long_f32", "xm_segsum_long_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 4 + [_I] * 8 + [_P]
            fn.restype = _I
        lib.xm_segsum_floor.argtypes = [_I] * 3 + [_P]
        lib.xm_segsum_floor.restype = _I
        for name in ("xm_segsum_blocked_f32", "xm_segsum_blocked_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 3 + [_I] * 5 + [_P]
            fn.restype = _I
        lib._xm_typed = True
    return lib


def _suffix(vals: torch.Tensor, what: str) -> str:
    if vals.dim() != 2:
        raise ValueError(f"{what}: vals must be (E, D), got {tuple(vals.shape)}")
    if vals.dtype == torch.float32:
        return "f32"
    if vals.dtype == torch.float64:
        return "f64"
    raise TypeError(f"{what}: dtype {vals.dtype}, expected float32/float64")


@launcher
def sorted_segment_sum(vals: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int, band: int = 0,
                       offsets: "torch.Tensor | None" = None) -> torch.Tensor:
    """Segment sum over sorted ``seg_ids``: ``(S, D)`` from ``vals (E, D)``.

    ``offsets``: the ``(S+1,)`` int32 CSR offsets of ``seg_ids`` (computed
    here when absent); the CUDA kernel reads them instead of the ids.  When
    they carry a host plan (:func:`planned_offsets`) with long segments and
    the rows are at most ``LONG_MAX_D`` wide, the launch gives each long
    segment a block of its own; otherwise one thread an output,
    :func:`csr_threads` a block, :func:`csr_batch` rows in flight a thread.
    ``band`` is the reference kernel's bound (:func:`max_band`); neither
    version needs it.  Each launch is counted in ``launches``, by
    ``"f32 D=3"``-style keys in ``shapes`` and by ``"<layout> f32 D=3"``
    keys in ``layouts`` (``unplanned`` without a plan).
    """
    if _on_cpu(vals, seg_ids):
        return sorted_segment_sum_plain(vals, seg_ids, num_segments)
    sfx = _suffix(vals, "sorted_segment_sum")
    dev = vals.device
    if dev.type != "cuda":
        raise ValueError(f"sorted_segment_sum: unsupported device {dev}")
    E, D = vals.shape
    if offsets is None:
        offsets = segment_offsets(seg_ids, num_segments)
    plan = getattr(offsets, "csr_plan", None)
    if plan is not None and (plan.rows, plan.segments) != (E, num_segments):
        raise ValueError(f"sorted_segment_sum: the offsets' plan is for "
                         f"{plan.rows} rows in {plan.segments} segments, "
                         f"got {E} in {num_segments}")
    out = torch.empty((num_segments, D), dtype=vals.dtype, device=dev)
    ptrs = [_check("vals", vals, (E, D), dev, vals.dtype),
            _check("offsets", offsets, (num_segments + 1,), dev, torch.int32),
            _check("out", out, (num_segments, D), dev, vals.dtype)]
    batch = csr_batch(E, num_segments, D)
    with torch.cuda.device(dev):    # ctypes launches on the current device
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan is not None and plan.n_long and D <= LONG_MAX_D:
            longs = _check("plan", plan.longs, (plan.n_long, 3), dev,
                           torch.int32)
            stage = long_stage_bytes(D, vals.element_size())
            rc = getattr(_lib(), f"xm_segsum_long_{sfx}")(
                ptrs[0], ptrs[1], longs, ptrs[2], num_segments, D,
                plan.n_long, plan.n_short, plan.long_rows,
                long_tile_rows(D, vals.element_size(), stage), stage, batch,
                stream)
        else:
            rc = getattr(_lib(), f"xm_segsum_{sfx}")(
                *ptrs, num_segments, D, csr_threads(num_segments, D), batch,
                stream)
    _raise_on(rc, "sorted_segment_sum")
    sorted_segment_sum.launches += 1
    for counter, key in (
            (sorted_segment_sum.shapes, f"{sfx} D={D}"),
            (sorted_segment_sum.layouts,
             f"{plan.layout if plan is not None else 'unplanned'} {sfx} "
             f"D={D}")):
        counter[key] = counter.get(key, 0) + 1
    return out


sorted_segment_sum.shapes = {}
sorted_segment_sum.layouts = {}


@launcher
def sorted_segment_sum_blocked(vals: torch.Tensor, seg_ids: torch.Tensor,
                               num_segments: int, blk, first, band: int,
                               seg_block: int = SEG_BLOCK,
                               chunk: int = CHUNK) -> torch.Tensor:
    """Segment sum on the SCHEDULED layout of :func:`plan_blocks`
    (``vals``/``seg_ids`` of ``G*chunk`` rows; padding rows carry the
    block's first id and zero values).  ``blk``/``first`` are the
    schedule's (G,) arrays.  The CUDA kernel finds each block's visits from
    the ids themselves (a visit's first id) and each output element starts
    from zero, so it reads neither ``blk`` (beyond its length G) nor
    ``first``; nor ``band``, which is checked and kept so callers port
    unchanged."""
    G = len(blk)
    E = vals.shape[0]
    if E != G * chunk:
        raise ValueError(f"sorted_segment_sum_blocked: {E} rows, expected "
                         f"G*chunk = {G}*{chunk}")
    if _on_cpu(vals, seg_ids):
        return sorted_segment_sum_plain(vals, seg_ids, num_segments)
    sfx = _suffix(vals, "sorted_segment_sum_blocked")
    dev = vals.device
    if dev.type != "cuda":
        raise ValueError(f"sorted_segment_sum_blocked: unsupported device "
                         f"{dev}")
    if not 1 <= band <= seg_block:
        raise ValueError(f"sorted_segment_sum_blocked: band {band} outside "
                         f"1..{seg_block}")
    D = vals.shape[1]
    out = torch.empty((num_segments, D), dtype=vals.dtype, device=dev)
    ptrs = [_check("vals", vals, (E, D), dev, vals.dtype),
            _check("seg_ids", seg_ids, (E,), dev, torch.int32),
            _check("out", out, (num_segments, D), dev, vals.dtype)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(_lib(), f"xm_segsum_blocked_{sfx}")(
            *ptrs, G, num_segments, chunk, seg_block, D, stream)
    _raise_on(rc, "sorted_segment_sum_blocked")
    sorted_segment_sum_blocked.launches += 1
    return out


class Segments:
    """Sums of per-edge rows by an id that need not be sorted (the scatters
    of the mapper's tail stages), through :func:`sorted_segment_sum`.

    Built once per solve on the host: one stable ``np.argsort`` of ``ids``
    (skipped when they are already sorted; of a 16-bit copy where
    ``num_segments`` allows, which numpy sorts by radix: the same
    permutation), the sorted ids and their CSR
    offsets with their host plan (:func:`planned_offsets`, named
    ``layout``), all on ``device``.  :meth:`sum` gathers the rows through
    that permutation and sums each segment in the callers' edge order, so
    on the card the bits are the CPU twin's, the same on every run.  Rows
    of any trailing shape are summed as flat rows of width ``D``.  An id
    outside ``[0, num_segments)`` raises ``ValueError`` here, on every
    device (the twin's ``index_add_`` would raise only at the sum).
    """

    def __init__(self, ids, num_segments: int, device,
                 layout: str = "unnamed"):
        ids = np.asarray(ids, dtype=np.int64)
        if len(ids) and not (ids.min() >= 0 and ids.max() < num_segments):
            raise ValueError(f"Segments ({layout}): ids in [{ids.min()}, "
                             f"{ids.max()}], outside [0, {num_segments})")
        perm = np.argsort(ids.astype(np.uint16) if num_segments <= 1 << 16
                          else ids, kind="stable")
        dev = torch.device(device)
        self.num_segments = int(num_segments)
        self.perm = (None if np.array_equal(perm, np.arange(len(ids)))
                     else torch.as_tensor(perm, device=dev))
        ids_s = ids[perm]
        self.ids = torch.as_tensor(ids_s, device=dev)
        self.offsets = planned_offsets(
            np.searchsorted(ids_s, np.arange(self.num_segments + 1)), dev,
            layout)

    def sum(self, vals: torch.Tensor) -> torch.Tensor:
        """``(S,) + vals.shape[1:]`` segment sums of ``vals (E, ...)``."""
        rows = vals.reshape(vals.shape[0], int(np.prod(vals.shape[1:])))
        if self.perm is not None:
            rows = rows[self.perm]
        out = sorted_segment_sum(rows.contiguous(), self.ids,
                                 self.num_segments, offsets=self.offsets)
        return out.reshape((self.num_segments,) + tuple(vals.shape[1:]))
