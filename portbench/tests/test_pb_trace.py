"""The trace's reduction and the per-layer readers, on a made-up trace."""

from types import SimpleNamespace

import pytest

import pb_tiny  # noqa: F401
import pb_roofline
import pb_spec
import pb_trace

# a 100 us window: two tcg_step launches, a dense one, a segment sum and a
# copy, with the host inside an item read during the longest gap
TRACE = pb_trace.Trace(
    device=[("void tcg_step_kernel<8, false>(StepArgs)", 10_000, 4_000),
            ("void tcg_step_kernel<8, false>(StepArgs)", 20_000, 4_000),
            ("void tcg_step_kernel<8, true>(StepArgs)", 30_000, 10_000),
            ("void segsum_csr<float, 1>(...)", 60_000, 2_000),
            ("Memcpy DtoH", 61_000, 3_000)],
    host=[("pb.solve", 0, 100_000), ("aten::item", 41_000, 59_000)],
    w0=0, w1=100_000)


def record(**kw):
    return SimpleNamespace(trace=TRACE, traced=[object(), object()], **kw)


def test_busy_idle_and_breakdown():
    assert pb_trace.busy_ns(TRACE) == 4_000 + 4_000 + 10_000 + 4_000
    assert pb_spec.reader("device.idle_pct")(record()) == pytest.approx(78.0)
    assert pb_spec.reader("host.launches_per_solution")(record()) == 2.0
    top = pb_trace.top_device_ops(TRACE)
    assert top[0] == ["void tcg_step_kernel<8, true>(StepArgs)", 1e-5]
    gaps = dict(pb_trace.idle_by_host(TRACE))
    assert gaps["aten::item"] == pytest.approx((60_000 - 40_000) / 1e9)
    assert sum(gaps.values()) == pytest.approx(78_000 / 1e9)


def test_roofline_shares_and_their_cross_check():
    launches = SimpleNamespace(tcg={(False, 1934, 3): [2, 1],
                                    (True, 120, 4): [1, 1]},
                               segsum={(270336, 24576, 3, 4, 24577): 1})
    rec = record(launches=launches)
    least = pb_roofline.least_seconds(*pb_roofline.step_bytes_ops(1934, 3),
                                      pb_roofline.PEAK_F32)
    assert pb_roofline.tcg_share(rec, False) == pytest.approx(
        100 * least / 8e-6)
    assert 0 < pb_roofline.tcg_share(rec, True) < 100
    assert 0 < pb_roofline.segsum_share(rec) < 100
    launches.tcg[(False, 1934, 3)][0] = 3       # a launch the trace lost
    with pytest.raises(RuntimeError, match="profiler recorded 2"):
        pb_roofline.tcg_share(rec, False)
