"""The ``ladybug1723.certify`` cell: its configuration, the frozen
generator at the configuration's sizes, the operator the port's policy
picks there, and the readers of the implicit operator's span and counters
on a made-up run."""

from types import SimpleNamespace

import numpy as np
import pytest

import pb_tiny  # noqa: F401
import pb_scenes
import pb_spans
import pb_spec
import pb_trace
from xmtpu_torch.pipeline.xm2 import choose_implicit

CELL = "ladybug1723.certify"


@pytest.fixture(scope="module")
def cell():
    return pb_spec.find_cell(CELL, pb_spec.load_benchmark())


def test_the_cell_loads_its_configuration(cell):
    cfg = cell.config
    assert cfg["name"] == "ladybug1723" and cell.chips == 1
    assert cfg["reduced"] == []
    src = cfg["source_sizes"]
    assert (cfg["scene"]["n_cameras"], cfg["scene"]["n_points"]) == (
        src["n_cameras"], src["n_points"]) == (1723, 156502)
    assert cfg["operator"] == "schurq" and cfg["solve"]["edge_tf"]
    names = [m["name"] for m in cell.per_layer]
    for m in ("schurq.idle_pct", "schurq.applies_per_solution",
              "segsum_roofline", "device.idle_pct"):
        assert m in names
    assert "tcg_step_roofline" not in names
    assert {m["name"] for m in cell.end_to_end} == {
        "solution_s", "peak_mem_gib", "setup_s"}


def test_the_policy_picks_schurq(cell):
    sc = cell.config["scene"]
    N, M = sc["n_cameras"], sc["n_points"]
    assert choose_implicit(N, M)
    # the dense route's estimate, 13.30 GB, against the 4 GB budget
    assert (9 * N * N + 6 * N * (N + M)) * 8 == pytest.approx(13.30e9,
                                                              rel=1e-3)


def test_the_generator_at_the_configuration_sizes(cell):
    cfg = cell.config
    sc = pb_scenes.GENERATORS[cfg["generator"]](**cfg["scene"],
                                                 seed=cfg["scene_seeds"][0])
    assert sc.N == 1723 and sc.M == 156502
    assert len(sc.edges) == 1723 * (390 + 4) == 678862
    seen = np.bincount(sc.edges[:, 1] - 1, minlength=sc.M)
    assert seen.min() >= 2
    assert np.bincount(sc.edges[:, 0] - 1, minlength=sc.N).min() == 394


# a 100 us window: a solve whose trust region and certificate each apply
# the implicit operator, and its recovery
TRACE = pb_trace.Trace(
    device=[("segsum_csr", 12_000, 3_000), ("tcg_step_kernel", 20_000, 4_000),
            ("gemm", 45_000, 5_000), ("segsum_csr", 86_000, 3_000)],
    host=sorted([
        ("pb.window", 0, 100_000),
        ("xm.solve", 5_000, 80_000),
        ("xm.stage", 6_000, 79_000),
        ("xm.tr.chunk.f32", 8_000, 40_000),
        ("xm.tr.tcg", 10_000, 30_000),
        ("xm.schurq.apply", 11_000, 16_000),
        ("xm.cert", 41_000, 78_000),
        ("xm.schurq.apply", 42_000, 52_000),
        ("xm.recover", 82_000, 95_000)], key=lambda h: h[1]),
    w0=0, w1=100_000)

IDLE = ["trust_region.idle_pct", "certificate.idle_pct", "recover.idle_pct",
        "staircase.idle_pct", "schurq.idle_pct"]


def record(trace=TRACE, traced=()):
    return SimpleNamespace(trace=trace, traced=list(traced))


def test_the_apply_span_takes_its_own_idle_line():
    rec = record()
    got = pb_spec.reader("schurq.idle_pct")(rec)
    # idle [11,12) [15,16) under the tCG's apply, [42,45) [50,52) under the
    # certificate's
    assert got == pytest.approx(100.0 * 7_000 / 100_000)
    parts = sum(pb_spec.reader(m)(rec) for m in IDLE)
    rest = 100.0 * pb_spans.split(rec)["idle"][pb_spans.NONE] / 100_000
    assert parts + rest == pytest.approx(
        pb_spec.reader("device.idle_pct")(rec), abs=1e-9)


def _solution(stages):
    return SimpleNamespace(result=SimpleNamespace(stages=tuple(stages)))


def test_applies_per_solution():
    applies = pb_spec.reader("schurq.applies_per_solution")
    sols = [_solution([dict(rank=3, applies_f64=40, applies_tf=300,
                            applies_f32=2000),
                       dict(rank=4, applies_f64=10, applies_tf=50,
                            applies_f32=600)]),
            _solution([dict(rank=3, applies_f64=30, applies_tf=200,
                            applies_f32=1000)]),
            SimpleNamespace(result=None)]
    assert applies(record(traced=sols)) == (3000 + 1230) / 2


@pytest.mark.parametrize("metric", ["schurq.idle_pct",
                                    "schurq.applies_per_solution"])
def test_nothing_to_read_without_the_span_or_counters(metric):
    read = pb_spec.reader(metric)
    assert read(record(trace=None)) is None
    # a program without the span (the dense route, or the parent)
    bare = TRACE._replace(host=[h for h in TRACE.host
                                if h[0] != "xm.schurq.apply"])
    old = [_solution([dict(rank=3, host_reads=7, graph_replays=0)])]
    assert read(record(bare, old)) is None
