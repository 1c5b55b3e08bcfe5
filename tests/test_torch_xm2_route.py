"""The ``ladybug1723.xm2`` cell's route (``portbench/routes/xm2.py``) on the
host, on a small window scene with planted outliers: ``xm2_solve`` whole is
served and judged ``correct``; a wrong cut fails ``cut_err``, a wrong
``lam`` fails ``lam_err``, a probe stopped short of its tolerance fails
``probe_grad``, a first pass judged at ``lam = 0`` fails ``primal_err``,
and the float32 control fails the precision checks.  Then
the cell's three new readers on a made-up trace.  The judge imports
nothing of the program but what it judges: its cut and scale test are its
own."""

import copy
import inspect
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from xmtpu_torch.pipeline import xm2 as txm2

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "portbench")
for _p in (BENCH, os.path.join(BENCH, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import control  # noqa: E402
import pb_judge  # noqa: E402
import pb_penalty  # noqa: E402
import pb_reference  # noqa: E402
import pb_spans  # noqa: E402
import pb_spec  # noqa: E402
import pb_trace  # noqa: E402
import run  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**33 + 5
CELL = "ladybug1723.xm2"
SMALL = dict(n_cameras=60, n_points=240, obs_per_camera=12, long_range=4,
             noise=1e-3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the solves here are many small products, which
    the suite's parallel workers would otherwise crowd off the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cell(monkeypatch):
    """The cell at a small scene, two instances of it, kept on ``SchurQ``
    by a 1-byte dense budget."""
    monkeypatch.setenv("XMTPU_DENSE_BUDGET", "1")
    cell = pb_spec.find_cell(CELL, pb_spec.load_benchmark())
    cfg = copy.deepcopy(cell.config)
    cfg["scene"], cfg["scene_seeds"] = dict(SMALL), [0, 1]
    return cell._replace(config=cfg)


@pytest.fixture(scope="module")
def served():
    """The route, its scenes and one request of each, served once."""
    mp = pytest.MonkeyPatch()
    cell = small_cell(mp)
    route = pb_spec.load_route(cell)
    scenes = route.scenes(cell.config)
    sols = [route.request(k, route.setup(sc, cell.config, CPU), cell.config,
                          CPU) for k, sc in enumerate(scenes)]
    yield cell, route, scenes, sols
    mp.undo()


def _checks(cell, route, scenes, sols):
    worst, failed, _ = route.judge(scenes, list(scenes), sols, cell.config,
                                   SEED, CPU, log=lambda *a: None)
    return pb_judge.verdict(worst, failed, cell.config["limits"],
                            route.CHECKS)


def test_the_configuration_is_xm2_at_its_defaults_on_ladybugs_scenes():
    bench = pb_spec.load_benchmark()
    cell = pb_spec.find_cell(CELL, bench)
    cfg = cell.config
    params = inspect.signature(txm2.xm2_solve).parameters
    assert cfg["solve"] == {k: params[k].default for k in cfg["solve"]}
    assert set(params) - set(cfg["solve"]) == {
        "edges", "weights", "landmarks", "rgbs", "N", "M", "verbose",
        "timer", "device"}
    with open(os.path.join(BENCH, "configs", "ladybug1723.json")) as f:
        base = json.load(f)
    assert cfg["scene"] == base["scene"] and cfg["reduced"] == []
    assert cfg["generator"] == base["generator"]
    assert cfg["scene_seeds"] == base["scene_seeds"][:1]
    assert cell.chips == 1 and cell.traffic["clients"] == 1
    assert os.path.basename(cell.route) == "xm2.py"
    for name in ("cut_err", "lam_err"):
        assert cfg["limits"][name] == 0
    assert cfg["limits"]["probe_grad"] == 1.0
    layer = {m["name"] for m in cell.per_layer}
    assert {"schurq.build.idle_pct", "xm2.host.idle_pct", "xm2.idle_pct",
            "schurq.idle_pct", "schurq.applies_per_solution",
            "schurq.fused_pct", "segsum_roofline",
            "device.idle_pct"} <= layer


def test_outliers_are_planted_from_the_scene_seed(served):
    cell, route, scenes, _ = served
    again = route.scenes(cell.config)
    for k, (a, b) in enumerate(zip(scenes, again)):
        E = len(a.scene.edges)
        assert a.planted.sum() == E // 30
        np.testing.assert_array_equal(a.scene.landmarks, b.scene.landmarks)
        moved = np.abs(a.scene.landmarks - route.pb_scenes.make_scene_window(
            **cell.config["scene"], seed=cell.config["scene_seeds"][k])
            .landmarks).sum(axis=1) > 0
        np.testing.assert_array_equal(moved, a.planted)
    assert not np.array_equal(scenes[0].planted, scenes[1].planted)


def test_a_request_is_xm2_whole_and_comes_out_correct(served):
    cell, route, scenes, sols = served
    for s in sols:
        assert not s.error and len(s.results) == 3
        first, last = s.outputs
        assert first.obs is None and first.lam is None
        assert last.lam == 0.0 and last.output.certified
        assert 0 < s.recover_s < s.wall_s
        assert len(last.obs.rows) < len(scenes[s.scene].scene.edges)
    ok, checks = _checks(cell, route, scenes, sols)
    assert ok, checks
    assert list(checks) == list(pb_judge.CHECKS) + ["cut_err", "lam_err",
                                                    "probe_grad"]
    assert checks["cut_err"]["value"] == 0 and checks["lam_err"]["value"] == 0
    assert 0 < checks["probe_grad"]["value"] <= 1


def test_a_final_pass_at_lam_is_judged_at_its_lam(monkeypatch):
    """The probe's scales made degenerate, as they read at Ladybug-1723's
    size: the program solves pass 2 at ``lam = |E| / N``, and the judge
    holds it to the penalised reference there.  (At this small size seed
    0's instance ends pass 2 uncertified at rank 5: XM^2's fast route stops
    at its noise floor, as the JAX package's does on small window scenes
    with outliers.  Seed 1's certifies.)  The planted scales are not the
    probe's: its primal is 25 times the objective at them, so the probe's
    ``primal_err`` fails, and no other check."""
    cell = small_cell(monkeypatch)
    cell.config["scene_seeds"] = [1]
    real = txm2._solve_recover

    def shrunk(*a, rank3_probe=False, **kw):
        res, rec = real(*a, rank3_probe=rank3_probe, **kw)
        if rank3_probe:
            res = res._replace(s_ex=res.s_ex * 0.2)
        return res, rec

    monkeypatch.setattr(txm2, "_solve_recover", shrunk)
    route = pb_spec.load_route(cell)
    scenes = route.scenes(cell.config)
    sols = [route.request(k, sc, cell.config, CPU)
            for k, sc in enumerate(scenes)]
    for s in sols:
        last = s.outputs[1]
        assert last.lam == len(last.obs.edges) / last.obs.N > 0
    ok, checks = _checks(cell, route, scenes, sols)
    assert not ok and checks.pop("primal_err")["value"] == pytest.approx(24)
    for name, c in checks.items():
        assert c["value"] <= c["limit"], (name, c)


def test_a_wrong_cut_fails_cut_err(monkeypatch):
    cell = small_cell(monkeypatch)
    real = txm2.xm2_residuals

    def skewed(edges, *a, **kw):
        # every third observation's residual weighed three times
        return real(edges, *a, **kw) * np.where(
            np.arange(len(edges)) % 3 == 0, 3.0, 1.0)

    monkeypatch.setattr(txm2, "xm2_residuals", skewed)
    cell.config["scene_seeds"] = [0]
    res = run.run_cell(cell, SEED, 0.1, False, CPU, log=lambda *a: None)
    assert res["correct"] is False and res["failed"] == 0
    assert res["checks"]["cut_err"]["value"] > 0


def test_a_wrong_lam_fails_lam_err(served):
    cell, route, scenes, sols = served
    # the probe's scales as a degenerate solve leaves them: the scale test
    # asks for lam = |E| / N where the program kept 0
    planted = []
    for s in sols:
        first, probe, last = s.results
        tiny = probe._replace(s_ex=np.full_like(probe.s_ex, 0.05))
        planted.append(s._replace(results=(first, tiny, last)))
    ok, checks = _checks(cell, route, scenes, planted)
    assert not ok and checks["lam_err"]["value"] == len(sols)
    assert checks["cut_err"]["value"] == 0


def test_a_probe_stopped_short_fails_probe_grad(monkeypatch):
    """The rank-3 probe stopped at ten times its tolerance: the cut
    and the scale test agree with the program's (they read what it gave),
    the probe's gradient under the reference's C does not."""
    cell = small_cell(monkeypatch)
    cell.config["scene_seeds"] = [0]
    real = txm2._solve_recover

    def short(op, Abar, implicit, max_rank, tol, *a, rank3_probe=False,
              **kw):
        return real(op, Abar, implicit, max_rank,
                    10 * tol if rank3_probe else tol, *a,
                    rank3_probe=rank3_probe, **kw)

    monkeypatch.setattr(txm2, "_solve_recover", short)
    route = pb_spec.load_route(cell)
    scenes = route.scenes(cell.config)
    sols = [route.request(k, sc, cell.config, CPU)
            for k, sc in enumerate(scenes)]
    ok, checks = _checks(cell, route, scenes, sols)
    assert not ok and checks["probe_grad"]["value"] > 1
    for name in pb_judge.CHECKS + ("cut_err", "lam_err"):
        assert checks[name]["value"] <= checks[name]["limit"], name


def test_at_lam_zero_the_penalised_judge_is_the_plain_one(served):
    """``pb_penalty.judge_output`` at ``lam = 0`` reads what
    ``pb_judge.judge_output`` reads (``cert`` to the certificate's start
    vectors, which the two draw in turn)."""
    cell, route, scenes, sols = served
    limits = cell.config["limits"]
    for s in sols:
        last = s.outputs[1]
        obs = last.obs
        el = pb_reference.eliminate(obs.edges, obs.weights, obs.landmarks,
                                    obs.N, obs.M, torch.float64, CPU)
        gen = torch.Generator().manual_seed(7)
        plain = pb_judge.judge_output(el, last.output, limits, gen, CPU)
        pen = pb_penalty.judge_output(el, last.output, 0.0, limits, gen, CPU)
        assert set(pen) == set(plain)
        for name in ("primal_err", "rot_err", "scale_err", "pos_err"):
            assert pen[name] == plain[name], name
        assert pen["cert"] == pytest.approx(plain["cert"], abs=1e-6)


def test_the_first_pass_judged_at_lam_zero_fails_primal_err(served,
                                                            monkeypatch):
    cell, route, scenes, sols = served
    real = pb_penalty.judge_set

    def at_zero(obs, X, applied, judged, *a, **kw):
        return real(obs, X, applied, [j._replace(lam=0.0) for j in judged],
                    *a, **kw)

    monkeypatch.setattr(pb_penalty, "judge_set", at_zero)
    ok, checks = _checks(cell, route, scenes, sols)
    assert not ok
    assert checks["primal_err"]["value"] > cell.config["limits"]["primal_err"]
    for name in ("op_err", "rot_err", "scale_err", "pos_err", "cut_err"):
        assert checks[name]["value"] <= checks[name]["limit"], name


def test_the_control_fails_where_the_program_passes(monkeypatch):
    cell = small_cell(monkeypatch)
    cell.config["scene_seeds"] = [0]
    out = control.readings(cell, SEED, CPU, torch.float32,
                           log=lambda *a: None)
    limits = cell.config["limits"]
    ok, _ = pb_judge.verdict(out["program"], out["program"]["failed"],
                             limits, pb_spec.load_route(cell).CHECKS)
    assert ok, out["program"]
    bad, checks = pb_judge.verdict(out["control"], out["control"]["failed"],
                                   limits)
    assert not bad
    for name in ("op_err", "primal_err", "rot_err", "scale_err", "pos_err"):
        assert checks[name]["value"] > limits[name], name


# ---- the readers: a 100 us window of one request, device work scattered

TRACE = pb_trace.Trace(
    device=[("segsum_csr", 6_000, 2_000),
            ("schurq_frame_out", 14_000, 3_000),
            ("gemv", 30_000, 4_000),
            ("getrf", 52_000, 2_000),
            ("segsum_csr", 66_000, 3_000),
            ("Memcpy DtoH", 88_000, 1_000)],
    host=sorted([
        ("pb.window", 0, 100_000),
        ("xm.xm2", 2_000, 96_000),
        ("xm.xm2.host", 3_000, 5_000),
        ("xm.schurq.build", 5_000, 12_000),
        ("xm.solve", 13_000, 40_000),
        ("xm.stage", 13_000, 40_000),
        ("xm.tr.chunk.f64", 13_000, 28_000),
        ("xm.schurq.apply", 14_000, 20_000),
        ("xm.cert", 28_000, 40_000),
        ("xm.recover", 41_000, 45_000),
        ("xm.xm2.host", 46_000, 50_000),
        ("xm.xm2.host", 50_000, 51_000),
        ("xm.schurq.build", 51_000, 70_000),
        ("xm.solve", 72_000, 90_000),
        ("xm.stage", 72_000, 90_000),
        ("xm.recover", 90_000, 94_000)], key=lambda h: h[1]),
    w0=0, w1=100_000)
NEW = ["schurq.build.idle_pct", "xm2.host.idle_pct", "xm2.idle_pct"]
OLD = ["trust_region.idle_pct", "certificate.idle_pct", "recover.idle_pct",
       "staircase.idle_pct", "schurq.idle_pct"]


def _record(trace=TRACE):
    return SimpleNamespace(trace=trace, traced=[])


def _pct(ns):
    return 100.0 * ns / 100_000


def test_the_readers_take_the_innermost_span():
    rec = _record()
    got = {m: pb_spec.reader(m)(rec) for m in NEW}
    # idle: [0,6) [8,14) [17,30) [34,52) [54,66) [69,88) [89,100) (us)
    # builds: [5,6) [8,12), [51,52) [54,66) [69,70)
    assert got["schurq.build.idle_pct"] == pytest.approx(_pct(19_000))
    # host stages: [3,5), [46,50), [50,51)
    assert got["xm2.host.idle_pct"] == pytest.approx(_pct(7_000))
    # xm.xm2 alone: [2,3) [12,13) [40,41) [45,46) [70,72) [94,96)
    assert got["xm2.idle_pct"] == pytest.approx(_pct(8_000))


@pytest.mark.parametrize("shift", [0, 1_700, 3_333])
def test_the_cells_idle_lines_partition_the_idle_share(shift):
    trace = TRACE._replace(
        device=[(n, s + shift, d) for n, s, d in TRACE.device
                if s + shift + d <= TRACE.w1])
    rec = _record(trace)
    parts = sum(pb_spec.reader(m)(rec) or 0.0 for m in NEW + OLD)
    rest = _pct(pb_spans.split(rec)["idle"][pb_spans.NONE])
    assert parts + rest == pytest.approx(
        pb_spec.reader("device.idle_pct")(rec), abs=1e-9)


def test_the_readers_read_nothing_without_their_spans():
    for m in NEW:
        assert pb_spec.reader(m)(_record(trace=None)) is None
    # the parent's program: no xm.xm2 spans, no build span
    bare = TRACE._replace(host=[h for h in TRACE.host if not h[0].startswith(
        ("xm.xm2", "xm.schurq.build"))])
    for m in NEW:
        assert pb_spec.reader(m)(_record(bare)) is None
    assert pb_spec.reader("recover.idle_pct")(_record(bare)) > 0
