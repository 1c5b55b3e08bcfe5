"""The long-segment path of ``sorted_segment_sum`` on the host: its plan and
a numpy mirror of its tile walk.

``csrc/segsum.cu``'s ``segsum_long`` gives each segment of more than
``CSR_LONG`` rows a thread block that streams the segment's contiguous rows
through a ring of shared-memory stages (16-byte ``cp.async`` copies of the
span's whole 16-byte chunks, one-value copies of the unaligned head and
tail), then adds each column in row order; the other segments keep the
one-thread-an-output walk.  The kernel runs only on the card; here the
plan it is given is checked, and its walk is mirrored in numpy at scaled
down sizes with the length profiles of the mapper's tail and last stage:
the CPU twin's bits, exactly (no tolerance: both add in row order from
zero in the values' own type).
"""

import numpy as np
import pytest
import torch

from xmtpu_torch.ops import schurq as sq
from xmtpu_torch.ops import segsum as ss
from xmtpu_torch.pipeline.synthetic import make_scene


def _lengths(layout, seed=0):
    """Segment lengths with each layout's profile, scaled down: ``one`` —
    one segment of 200 rows (BA's camera sums); ``twenty`` — 20 segments
    of ~300 rows, one of 600 (BA's image sums, the refine's frames);
    ``mixed`` — 300 segments of 0 to 40 rows (some empty) with a few of
    ~250 (BATA's cameras among its points); ``edge`` — segments of exactly
    ``CSR_LONG`` and ``CSR_LONG + 1`` rows, empty ones between."""
    rng = np.random.default_rng(seed)
    if layout == "one":
        return np.array([200])
    if layout == "twenty":
        L = rng.integers(250, 350, 20)
        L[7] = 600
        return L
    if layout == "mixed":
        L = rng.integers(0, 41, 300)
        L[rng.choice(300, 4, replace=False)] = rng.integers(230, 270, 4)
        return L
    assert layout == "edge"
    return np.array([0, ss.CSR_LONG, 0, ss.CSR_LONG + 1, 3, 0,
                     ss.CSR_LONG + 1, 0])


LAYOUTS = ["one", "twenty", "mixed", "edge"]


def _offsets(L):
    return np.concatenate([[0], np.cumsum(L)]).astype(np.int64)


def _plan_rows(plan):
    return plan.longs.numpy().astype(np.int64)


@pytest.mark.parametrize("long_rows", [0, ss.CSR_LONG, 10_000])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plan_covers_every_row_once(layout, long_rows, monkeypatch):
    """The launch the plan describes: block j < n_long sums the long
    segment ``longs[j]`` (its rows in tiles, in order), the short-segment
    tiles' threads sum every other segment (empty ones to zero): each
    segment is summed by exactly one of them, each row read exactly once,
    the long segments longest first."""
    L = _lengths(layout)
    off = _offsets(L)
    monkeypatch.setattr(ss, "CSR_LONG", long_rows)
    plan = ss.csr_plan(off, "cpu", layout)
    rows = _plan_rows(plan)
    assert plan.rows == off[-1] and plan.segments == len(L)
    assert plan.long_rows == long_rows and plan.longest == L.max()
    assert plan.n_long == len(rows) == int((L > long_rows).sum())
    assert plan.n_short == len(L) - plan.n_long
    assert plan.longs.dtype == torch.int32 and plan.longs.shape == (
        plan.n_long, 3)
    assert np.all(np.diff(rows[:, 2] - rows[:, 1]) <= 0)   # longest first
    summed = np.zeros(len(L), np.int64)
    read = np.zeros(off[-1], np.int64)
    tile = ss.long_tile_rows(6, 8, ss.long_stage_bytes(6, 8))
    for seg, r0, r1 in rows:
        assert (r0, r1) == (off[seg], off[seg + 1])
        summed[seg] += 1
        for a in range(r0, r1, tile):       # the block's tiles, in order
            read[a:min(a + tile, r1)] += 1
    for s in range(len(L)):                 # the short-segment threads
        if L[s] <= long_rows:
            summed[s] += 1
            read[off[s]:off[s + 1]] += 1
    assert np.all(summed == 1) and np.all(read == 1)


def test_plan_rides_only_on_its_own_offsets():
    """``planned_offsets`` gives int32 offsets on the device that carry
    their plan; a copy, a slice or a concatenation does not carry it (so no
    cut or padded layout meets a stale plan).  ``Segments`` names its
    layout; ``SchurQ.build`` plans both orderings, which its cast, moved,
    two-float and mixed forms keep (the same tensors), and
    ``pad_cameras`` drops (new frame offsets)."""
    off = ss.planned_offsets(_offsets(_lengths("mixed")), "cpu", "m")
    assert off.dtype == torch.int32 and off.csr_plan.layout == "m"
    for other in (off.clone(), off[:-1], torch.cat([off, off[-1:]]),
                  off.to(torch.int64)):
        assert getattr(other, "csr_plan", None) is None
    assert off.to("cpu") is off and off.contiguous() is off

    seg = ss.Segments(np.repeat(np.arange(5), [3, 0, 150, 1, 2]), 5, "cpu",
                      "BA camera")
    assert seg.offsets.csr_plan.layout == "BA camera"
    assert seg.offsets.csr_plan.n_long == 1

    sc = make_scene(n_cameras=8, n_points=300, obs_per_camera=150,
                    noise=0.0, seed=0)
    Q = sq.SchurQ.build(sc.weights, sc.edges, sc.landmarks, device="cpu")
    assert Q.bounds_l.csr_plan.layout == "SchurQ landmark"
    assert Q.bounds_f.csr_plan.layout == "SchurQ frame"
    assert Q.bounds_f.csr_plan.n_long == int(
        (np.diff(Q.bounds_f.numpy()) > ss.CSR_LONG).sum()) > 0
    for q in (Q.cast(torch.float32), Q.to("cpu"), Q.edge_f32(),
              Q.two_float()):
        assert q.bounds_l is Q.bounds_l and q.bounds_f is Q.bounds_f
    padded = sq.pad_cameras(Q, Q.n_cameras + 2)
    assert getattr(padded.bounds_f, "csr_plan", None) is None


def test_wrapper_on_host_takes_the_twin_and_checks_nothing_of_the_plan():
    """On CPU tensors the planned offsets change nothing: the twin's sums,
    no launch counted."""
    L = _lengths("twenty")
    ids = np.repeat(np.arange(len(L)), L)
    vals = torch.tensor(np.random.default_rng(0).normal(size=(len(ids), 6)))
    off = ss.planned_offsets(_offsets(L), "cpu", "twenty")
    n0 = ss.sorted_segment_sum.launches
    got = ss.sorted_segment_sum(vals, torch.tensor(ids), len(L),
                                offsets=off)
    assert ss.sorted_segment_sum.launches == n0
    assert torch.equal(got, ss.sorted_segment_sum_plain(
        vals, torch.tensor(ids), len(L)))


def _stage_tile(mem, addr0, a, b, itemsize, buf, hits):
    """numpy mirror of ``stage_tile``: the values ``[a, b)`` of an array
    that starts at byte address ``addr0`` (its bytes ``mem``) copied into
    the stage ``buf``, value ``a`` at byte ``(addr0 + a * itemsize) % 16``.
    Each copy is checked to lie inside the span and, for a 16-byte copy, to
    be aligned at both ends; ``hits`` counts the copies of each value."""
    A, B = addr0 + a * itemsize, addr0 + b * itemsize
    base, c0, c1 = A & ~15, (A + 15) & ~15, B & ~15
    ts = max(c0, c1)
    copies = []
    if c1 > c0:                                  # the whole chunks
        copies.append((c0 - base, c0, c1 - c0))
        assert c0 % 16 == 0 and (c0 - base) % 16 == 0 and (c1 - c0) % 16 == 0
    head = (min(c0, B) - A) // itemsize
    tail = (B - ts) // itemsize if B > ts else 0
    assert head < 16 // itemsize and tail < 16 // itemsize
    copies += [(A - base + j * itemsize, A + j * itemsize, itemsize)
               for j in range(head)]
    copies += [(ts - base + k * itemsize, ts + k * itemsize, itemsize)
               for k in range(tail)]
    for dst, src, n in copies:
        assert A <= src and src + n <= B         # nothing outside the span
        buf[dst:dst + n] = mem[src - addr0:src - addr0 + n]
        hits[(src - addr0) // itemsize:(src + n - addr0) // itemsize] += 1
    return A & 15


def _long_walk(vals, off, plan, addr0, stage_bytes):
    """numpy mirror of ``segsum_long``: the long blocks stream their tiles
    through ``LONG_STAGES`` stages in the kernel's order (the first
    ``LONG_STAGES - 1`` tiles staged ahead; each iteration stages tile
    ``k + LONG_STAGES - 1`` into tile ``k - 1``'s stage, then adds tile
    ``k``), the adders add each staged tile's rows in row order; the short
    threads add their segments' rows in row order, skipping the long ones.
    ``addr0``: the byte address the values start at (its 16-byte
    misalignment is what the copies must handle)."""
    E, D = vals.shape
    item = vals.itemsize
    mem = np.ascontiguousarray(vals).view(np.uint8).ravel()
    hits = np.zeros(E * D, np.int64)
    written = np.zeros(plan.segments, np.int64)
    out = np.full((plan.segments, D), np.nan, vals.dtype)
    tile_rows = ss.long_tile_rows(D, item, stage_bytes)
    assert tile_rows * D * item <= stage_bytes
    stride = stage_bytes + 16
    ring = np.zeros(ss.LONG_STAGES * stride, np.uint8)
    for seg, r0, r1 in _plan_rows(plan):
        tiles = -(-(r1 - r0) // tile_rows)
        shift = {}

        def stage(k):
            if k < tiles:
                a = r0 + k * tile_rows
                b = min(a + tile_rows, r1)
                st = (k % ss.LONG_STAGES) * stride
                shift[k] = _stage_tile(mem, addr0, a * D, b * D, item,
                                       ring[st:st + stride], hits)
        for k in range(ss.LONG_STAGES - 1):
            stage(k)
        acc = np.zeros(D, vals.dtype)
        for k in range(tiles):
            stage(k + ss.LONG_STAGES - 1)
            rows = min(tile_rows, r1 - r0 - k * tile_rows)
            st = (k % ss.LONG_STAGES) * stride + shift.pop(k)
            x = ring[st:st + rows * D * item].view(vals.dtype).reshape(
                rows, D)
            for i in range(rows):
                acc = acc + x[i]
        out[seg] = acc
        written[seg] += 1
    short = np.diff(off) <= plan.long_rows
    acc = np.zeros((plan.segments, D), vals.dtype)
    for i in range(int(np.diff(off)[short].max(initial=0))):
        live = short & (off[:-1] + i < off[1:])
        acc[live] = acc[live] + vals[off[:-1][live] + i]
    out[short] = acc[short]
    written[short] += 1
    long_rows = np.zeros(E, bool)
    for _, r0, r1 in _plan_rows(plan):
        long_rows[r0:r1] = True
    assert np.all(written == 1)
    assert np.all(hits.reshape(E, D)[long_rows] == 1)
    assert np.all(hits.reshape(E, D)[~long_rows] == 0)
    return out


# the misalignment of the values' first byte: every one a float32 or a
# float64 array can start at
MISALIGN = [(np.float32, 0), (np.float32, 4), (np.float32, 12),
            (np.float64, 0), (np.float64, 8)]


@pytest.mark.parametrize("stage", ["small", "kernel's"])
@pytest.mark.parametrize("dtype,misalign", MISALIGN)
@pytest.mark.parametrize("D", [1, 3, 6, 12, 16, 36])
@pytest.mark.parametrize("layout", ["one", "twenty", "mixed"])
def test_long_walk_is_the_cpu_twin(layout, D, dtype, misalign, stage):
    """The long path's tile walk, with the kernel's stages for the width
    (``long_stage_bytes``) and with small ones that wrap the ring many
    times: every value of a long segment copied exactly once and only
    from inside its span, every segment written once, and the sums the CPU
    twin's bits."""
    item = np.dtype(dtype).itemsize
    stage_bytes = 512 if stage == "small" else ss.long_stage_bytes(D, item)
    L = _lengths(layout, seed=D)
    off = _offsets(L)
    ids = np.repeat(np.arange(len(L)), L)
    vals = np.random.default_rng(D).normal(size=(len(ids), D)).astype(dtype)
    plan = ss.csr_plan(off, "cpu", layout)
    assert plan.n_long >= 1
    got = _long_walk(vals, off, plan, 4096 + misalign, stage_bytes)
    ref = ss.sorted_segment_sum(torch.tensor(vals), torch.tensor(ids),
                                len(L))
    assert np.array_equal(got, ref.numpy())
