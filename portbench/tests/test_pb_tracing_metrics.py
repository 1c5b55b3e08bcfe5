"""The readers of the program's spans and counters, on a made-up trace:
idle time by the innermost ``xm.`` span, host reads and the solve's memory
peak from ``SolveResult.stages``."""

from types import SimpleNamespace

import pytest

import pb_tiny  # noqa: F401
import pb_spans
import pb_spec
import pb_trace

IDLE = ["trust_region.idle_pct", "certificate.idle_pct", "recover.idle_pct",
        "staircase.idle_pct"]

# a 100 us window: one solve (two ranks, each a chunk with a tCG solve and a
# certificate) and its recovery, with device work scattered over it
TRACE = pb_trace.Trace(
    device=[("void tcg_step_kernel<8, false>(StepArgs)", 12_000, 3_000),
            ("void tcg_step_kernel<8, false>(StepArgs)", 14_000, 4_000),
            ("sm80_xmma_gemm", 30_000, 5_000),
            ("getrf", 44_000, 2_000),
            ("Memcpy DtoH", 71_000, 1_000),
            ("gemv", 86_000, 3_000)],
    host=sorted([
        ("pb.window", 0, 100_000),
        ("xm.solve", 5_000, 80_000),
        ("xm.stage", 6_000, 50_000),
        ("xm.tr.chunk.f32", 8_000, 40_000),
        ("aten::mm", 9_000, 11_000),
        ("xm.tr.tcg", 10_000, 30_000),
        ("aten::item", 20_000, 29_000),
        ("xm.cert", 41_000, 49_000),
        ("xm.stage", 52_000, 79_000),
        ("xm.tr.escape", 53_000, 56_000),
        ("xm.tr.chunk.f64", 57_000, 70_000),
        ("xm.cert", 70_000, 78_000),
        ("xm.recover", 82_000, 95_000)], key=lambda h: h[1]),
    w0=0, w1=100_000)


def record(trace=TRACE, traced=()):
    return SimpleNamespace(trace=trace, traced=list(traced))


def _pct(ns):
    return 100.0 * ns / 100_000


def test_idle_goes_to_the_innermost_span():
    rec = record()
    got = {m: pb_spec.reader(m)(rec) for m in IDLE}
    # idle: [0,12) [18,30) [35,44) [46,71) [72,86) [89,100) (us)
    # trust region: chunk.f32 [8,10) [35,40), tcg [10,12) [18,30), escape
    # [53,56), chunk.f64 [57,70)
    assert got["trust_region.idle_pct"] == pytest.approx(_pct(37_000))
    # certificates [41,44) + [46,49) + [70,71) + [72,78)
    assert got["certificate.idle_pct"] == pytest.approx(_pct(13_000))
    # recovery [82,86) + [89,95)
    assert got["recover.idle_pct"] == pytest.approx(_pct(10_000))
    # solve / stage alone: [5,6) [6,8) [40,41) [49,50) [50,52) [52,53)
    # [56,57) [78,79) [79,80)
    assert got["staircase.idle_pct"] == pytest.approx(_pct(11_000))
    # window outside any xm. span: [0,5) [80,82) [95,100)
    split = pb_spans.split(rec)
    assert split["idle"][pb_spans.NONE] == 12_000
    assert split["spans"]["xm.stage"] == [2, 44_000 + 27_000]


@pytest.mark.parametrize("shift", [0, 1_500, 4_321])
def test_the_layers_and_the_rest_partition_the_idle_share(shift):
    trace = TRACE._replace(
        device=[(n, s + shift, d) for n, s, d in TRACE.device
                if s + shift + d <= TRACE.w1])
    rec = record(trace)
    parts = sum(pb_spec.reader(m)(rec) for m in IDLE)
    rest = _pct(pb_spans.split(rec)["idle"][pb_spans.NONE])
    idle = pb_spec.reader("device.idle_pct")(rec)
    assert parts + rest == pytest.approx(idle, abs=1e-9)


def test_nothing_to_read_without_a_trace_or_spans():
    for m in IDLE:
        assert pb_spec.reader(m)(record(trace=None)) is None
    # a program without the spans: only the harness's own annotation
    bare = TRACE._replace(host=[("pb.window", 0, 100_000),
                                ("aten::mm", 9_000, 11_000)])
    for m in IDLE:
        assert pb_spec.reader(m)(record(bare)) is None
    # no recovery span: that layer reads nothing, the others read
    no_rec = TRACE._replace(host=[h for h in TRACE.host
                                  if h[0] != "xm.recover"])
    assert pb_spec.reader("recover.idle_pct")(record(no_rec)) is None
    assert pb_spec.reader("certificate.idle_pct")(record(no_rec)) > 0


def _solution(stages):
    return SimpleNamespace(result=SimpleNamespace(stages=tuple(stages)))


def test_host_reads_and_the_solve_peak():
    reads = pb_spec.reader("trust_region.host_reads_per_solution")
    peak = pb_spec.reader("staircase.peak_gib")
    gib = 2**30
    sols = [_solution([dict(rank=3, host_reads=300, mem_base_bytes=10 * gib,
                            peak_bytes=11 * gib, cert_peak_bytes=12 * gib),
                       dict(rank=4, host_reads=100, mem_base_bytes=10 * gib,
                            peak_bytes=12 * gib + gib // 2)]),
            _solution([dict(rank=3, host_reads=200, mem_base_bytes=4 * gib,
                            peak_bytes=5 * gib, cert_peak_bytes=5 * gib)]),
            SimpleNamespace(result=None)]
    rec = record(traced=sols)
    assert reads(rec) == 300.0
    assert peak(rec) == 2.5
    # an untraced run, or a program without the counters
    for r in (record(), record(traced=[_solution([dict(rank=3)])])):
        assert reads(r) is None and peak(r) is None
