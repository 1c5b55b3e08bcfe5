"""Spans and counters inside ``xmtpu_torch``'s solve (``utils/timer.py``),
on the host.

Under a recording profiler the solve path names its layers with
FUNCTION-scope ranges (``xm.solve`` > ``xm.stage`` > ``xm.tr.chunk.*`` >
``xm.tr.tcg``; ``xm.tr.escape`` and ``xm.cert`` in a stage; ``xm.recover``
beside the solve), which get no device-side twin; without one, ``span`` is
the shared no-op.  ``SolveResult.stages`` counts each rank's trust-region
host reads, which must equal the calls of the read sites.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from xmtpu_torch.assembly.creatematrix import create_matrix_arrays
from xmtpu_torch.ops import fused_tcg
from xmtpu_torch.ops.schurq import SchurQ
from xmtpu_torch.pipeline.recover import recover_XM, recover_XM_implicit
from xmtpu_torch.pipeline.synthetic import make_scene
from xmtpu_torch.solver import trust_region as tr
from xmtpu_torch.solver.staircase import solve_arrays
from xmtpu_torch.utils import timer

CPU = "cpu"
# seed 2 leaves rank 3 at a saddle: the staircase escapes and certifies at 4
NOISY = dict(n_cameras=30, n_points=100, obs_per_camera=10, noise=0.35,
             seed=2)
MIXED = dict(max_rank=6, tol=1e-6, precision="mixed", inner_f32=True,
             verbose=False, device=CPU)
IMPLICIT = dict(max_rank=4, tol=1e-6, precision="mixed", inner_f32=True,
                edge_tf=True, verbose=False, device=CPU)


@pytest.fixture(scope="module")
def dense():
    sc = make_scene(**NOISY)
    C, Abar = create_matrix_arrays(sc.weights, sc.edges, sc.landmarks,
                                   device=CPU)
    return C, Abar


@pytest.fixture(scope="module")
def implicit():
    sc = make_scene(n_cameras=8, n_points=40, obs_per_camera=20, noise=1e-3,
                    seed=77)
    return SchurQ.build(sc.weights, sc.edges, sc.landmarks, device=CPU)


def _solve_recover(kind, dense, implicit):
    if kind == "dense":
        C, Abar = dense
        res = solve_arrays(C, **MIXED)
        recover_XM(C, res.R, res.s_ex, Abar, 0.0, verbose=False)
    else:
        res = solve_arrays(implicit, **IMPLICIT)
        recover_XM_implicit(implicit, res.R, res.s_ex, 0.0, verbose=False)
    return res


def _xm_events(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("name", "").startswith("xm.")]


def _inside(e, outer):
    # Chrome-trace times are microseconds with nanosecond decimals
    return (outer["ts"] - 1e-3 <= e["ts"]
            and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"] + 1e-3)


def _parent(e, events, names):
    """The innermost event of ``names`` enclosing ``e`` on its thread."""
    around = [o for o in events if o is not e and o["name"] in names
              and o["tid"] == e["tid"] and _inside(e, o)]
    return min(around, key=lambda o: o["dur"]) if around else None


@pytest.mark.parametrize("kind", ["dense", "implicit"])
def test_solve_and_recover_emit_nested_spans(kind, dense, implicit,
                                             tmp_path):
    with timer.device_trace(str(tmp_path)) as path:
        res = _solve_recover(kind, dense, implicit)
    assert res.certified
    ev = _xm_events(path)
    names = {e["name"] for e in ev}
    assert names >= {"xm.solve", "xm.stage", "xm.tr.chunk.f32",
                     "xm.tr.chunk.f64", "xm.tr.tcg", "xm.cert",
                     "xm.recover"}
    if kind == "dense":
        assert res.rank == 4 and "xm.tr.escape" in names
    # FUNCTION-scope ranges: host ops, not user annotations
    assert {e["cat"] for e in ev} == {"cpu_op"}
    solves = [e for e in ev if e["name"] == "xm.solve"]
    stages = [e for e in ev if e["name"] == "xm.stage"]
    assert len(solves) == 1 and len(stages) == len(res.stages)
    chunks = {"xm.tr.chunk.f32", "xm.tr.chunk.f64"}
    for e in ev:
        if e["name"] == "xm.tr.tcg":
            assert _parent(e, ev, chunks) is not None
        if e["name"] in chunks | {"xm.tr.escape", "xm.cert"}:
            assert _parent(e, ev, {"xm.stage"}) is not None
        if e["name"] == "xm.stage":
            assert _parent(e, ev, {"xm.solve"}) is solves[0]
        if e["name"] == "xm.recover":
            assert _parent(e, ev, {"xm.solve"}) is None
        if e["name"] != "xm.solve":
            assert _parent(e, ev, {"xm.recover"}) is None
    # the spans sit where the stage_s / cert_s clocks do
    cert_us = sum(e["dur"] for e in ev if e["name"] == "xm.cert")
    stage_us = sum(e["dur"] for e in stages)
    cert_s = sum(s["cert_s"] for s in res.stages)
    total_s = sum(s["stage_s"] + s["cert_s"] for s in res.stages)
    assert 100 * cert_us / stage_us == pytest.approx(
        100 * cert_s / total_s, abs=1.0)
    for s in res.stages:
        # memory is read only on a card
        assert not {"mem_base_bytes", "peak_bytes", "cert_peak_bytes"} & set(s)


def test_spans_have_no_device_twin(dense):
    C, Abar = dense
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = solve_arrays(C, **MIXED)
        recover_XM(C, res.R, res.s_ex, Abar, 0.0, verbose=False)
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name().startswith("xm.")]
    assert {e.name() for e in ev} >= {"xm.solve", "xm.stage", "xm.tr.tcg",
                                      "xm.cert", "xm.recover"}
    assert not any(e.is_user_annotation() for e in ev)


def test_span_is_the_shared_no_op_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    off = timer.span("xm.solve")
    assert off is timer.span("xm.tr.tcg") is timer._OFF
    with off:
        with off:
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert timer.span("xm.solve") is not timer._OFF
    assert timer.span("xm.solve") is timer._OFF


def _routed_to_fused(monkeypatch):
    """The card's route on the host: every f32 preconditioned tCG solve
    through ``fused_tcg.inner_tcg_fused`` (its plain twins)."""
    generic = tr._inner_tcg

    def routed(qmul, R, *args, minv=None):
        if minv is not None and R.dtype == torch.float32:
            return fused_tcg.inner_tcg_fused(qmul, R, *args, minv)
        return generic(qmul, R, *args, minv=minv)

    monkeypatch.setattr(tr, "_inner_tcg", routed)


@pytest.mark.parametrize("route", ["dense", "dense_fused_loop", "implicit"])
def test_host_reads_count_the_read_sites(route, dense, implicit,
                                         monkeypatch):
    seen = {"_fetch": 0, "_read_carry": 0}

    def shim(mod, name):
        inner = getattr(mod, name)

        def counted(*args, **kwargs):
            seen[name] += 1
            return inner(*args, **kwargs)
        monkeypatch.setattr(mod, name, counted)

    shim(tr, "_fetch")
    shim(fused_tcg, "_read_carry")
    if route == "dense_fused_loop":
        _routed_to_fused(monkeypatch)
    counts = []
    for _ in range(2):
        before = dict(seen)
        if route == "implicit":
            res = solve_arrays(implicit, **IMPLICIT)
        else:
            res = solve_arrays(dense[0], **MIXED)
        assert res.certified
        per_rank = [s["host_reads"] for s in res.stages]
        assert all(r > 0 for r in per_rank)
        calls = sum(seen[k] - before[k] for k in seen)
        assert sum(per_rank) == calls
        counts.append(per_rank)
    assert counts[0] == counts[1]
    # every tCG reads its loop's carry: the fused loop's, or the device
    # scalars' of the eager loop
    assert seen["_read_carry"] > 0


def test_phases_are_spans():
    t = timer.PhaseTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.phase("pass1_assemble"):
            torch.ones(8).sum()
        with t.phase("pass1_solve_recover"):
            torch.ones(8).cumsum(0)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("pass1_assemble") == 1
    assert names.count("pass1_solve_recover") == 1
    assert t.counts == {"pass1_assemble": 1, "pass1_solve_recover": 1}
    assert "pass1_assemble" in t.report()
    assert np.all(np.array(list(t.totals.values())) > 0)
