"""Routes: the default one serves what the harness served before routes
existed, a route of two solves on two observation sets is served and
judged from its own file alone, and a configuration that names a missing
route is refused when its cell is found."""

import copy
import json
import os
import shutil
from types import SimpleNamespace

import pytest
import torch

import pb_tiny  # noqa: I001  (puts the benchmark on the path first)
import pb_judge
import pb_program
import pb_reference
import pb_scenes
import pb_spec
import run
from xmtpu_torch.pipeline.recover import recover_XM, recover_XM_implicit
from xmtpu_torch.solver.staircase import solve_arrays

CPU = torch.device("cpu")
SEED = 2**32 + 41
TWOPASS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "twopass.py")


def _before_routes(cell, seed):
    """The harness's path before routes, written out: the configuration's
    scenes, one operator each, one solve and its recovery each, the probe
    block's products, and the float64 reference eliminated once a scene.
    Returns the outputs' keys and the checks."""
    cfg, limits = cell.config, cell.config["limits"]
    scenes = [pb_scenes.GENERATORS[cfg["generator"]](**cfg["scene"], seed=s)
              for s in cfg["scene_seeds"]]
    ops = [pb_program.build_operator(sc, cfg, CPU) for sc in scenes]
    lam = cfg["solve"].get("lam", 0.0)
    keys, worst = [], {}
    for k, (sc, op) in enumerate(zip(scenes, ops)):
        res = solve_arrays(op.op, verbose=False, device=CPU, **cfg["solve"])
        rec = (recover_XM_implicit(op.op, res.R, res.s_ex, lam, verbose=False)
               if op.implicit else
               recover_XM(op.op, res.R, res.s_ex, op.Abar, lam, verbose=False))
        out = pb_judge.Output(k, res.R, res.s_ex, float(res.primal),
                              bool(res.certified), *rec)
        keys.append(out.key())
        X = pb_judge.probe_block(3 * sc.N, seed, k, CPU)
        el = pb_reference.eliminate(sc.edges, sc.weights, sc.landmarks, sc.N,
                                    sc.M, torch.float64, CPU)
        pb_judge.merge(worst, pb_judge.judge_scene(
            el, X, op.op.apply(X).numpy(), [out], limits, seed, k, CPU))
    return keys, pb_judge.verdict(worst, 0, limits)[1]


@pytest.mark.parametrize("name", ["bal1936.certify", "escape", "schurq"])
def test_the_default_route_serves_what_the_harness_served(name, monkeypatch):
    cell = pb_tiny.tiny_cell(name, monkeypatch)
    assert "route" not in cell.config
    assert cell.route == os.path.join(pb_spec.HERE, "routes", "certify.py")
    route = pb_spec.load_route(cell)
    cfg = cell.config
    scenes = route.scenes(cfg)
    held = [route.setup(sc, cfg, CPU) for sc in scenes]
    sols = [route.request(k, h, cfg, CPU) for k, h in enumerate(held)]
    for s in sols:
        assert len(s.results) == 1 and s.result is s.results[0]
        (j,) = s.outputs
        assert j.obs is None and j.lam == cfg["solve"].get("lam", 0.0)
    keys = [j.output.key() for s in sols for j in s.outputs]
    worst, failed, _ = route.judge(scenes, held, sols, cfg, SEED, CPU,
                                   log=lambda *a: None)
    assert not held                       # freed before the reference
    _, checks = pb_judge.verdict(worst, failed, cfg["limits"], route.CHECKS)
    want_keys, want_checks = _before_routes(cell, SEED)
    assert keys == want_keys
    assert checks == want_checks
    assert list(checks) == list(pb_judge.CHECKS)


def _twopass_cell(monkeypatch, plant=None):
    cell = pb_tiny.tiny_cell("bal1936.certify", monkeypatch)
    cfg = copy.deepcopy(cell.config)
    cfg["limits"]["cut_err"] = 0
    if plant:
        cfg["plant"] = plant
    return cell._replace(config=cfg, route=TWOPASS)


@pytest.mark.parametrize("plant", [None, "wrong_cut"])
def test_a_two_solve_route_from_its_own_file(plant, monkeypatch):
    cell = _twopass_cell(monkeypatch, plant)
    res = run.run_cell(cell, SEED, 0.1, False, CPU, log=lambda *a: None)
    checks = res["checks"]
    assert list(checks) == list(pb_judge.CHECKS) + ["cut_err"]
    others = {n: c for n, c in checks.items() if n != "cut_err"}
    for c in others.values():       # both passes pass the plain reference
        assert c["value"] <= c["limit"], others
    assert res["failed"] == 0 and res["attempted"] >= 2
    if plant is None:
        assert res["correct"] is True and checks["cut_err"]["value"] == 0
    else:
        assert res["correct"] is False and checks["cut_err"]["value"] > 0


def test_a_request_of_two_solves_is_counted_whole(monkeypatch):
    cell = _twopass_cell(monkeypatch)
    route = pb_spec.load_route(cell)
    cfg = cell.config
    (sc,) = route.scenes(dict(cfg, scene_seeds=[0]))
    sol = route.request(0, route.setup(sc, cfg, CPU), cfg, CPU)
    first, second = sol.results
    assert sol.result is second
    assert [j.lam for j in sol.outputs] == [0.0, 0.0]
    assert sol.outputs[0].obs is None and len(sol.outputs[1].obs.rows) < len(
        sc.edges)
    rec = SimpleNamespace(traced=[sol, sol])
    inner = pb_spec.reader("trust_region.inner_per_solution")(rec)
    assert inner == first.total_inner + second.total_inner
    stages = first.stages + second.stages
    reads = pb_spec.reader("trust_region.host_reads_per_solution")(rec)
    assert reads == sum(st["host_reads"] for st in stages)
    cert = sum(st["cert_s"] for st in stages)
    assert pb_spec.reader("certificate.pct")(rec) == pytest.approx(
        100.0 * cert / sum(st["stage_s"] + st["cert_s"] for st in stages))


def test_a_route_check_missing_from_the_limits_is_refused(monkeypatch):
    cell = _twopass_cell(monkeypatch)
    del cell.config["limits"]["cut_err"]
    with pytest.raises(KeyError, match="cut_err"):
        pb_spec.load_route(cell)


def test_a_missing_route_fails_when_the_cell_is_found(tmp_path):
    bench = pb_spec.load_benchmark()
    folder = tmp_path / pb_spec.FOLDER
    for sub in ("configs", "traffic"):
        shutil.copytree(os.path.join(pb_spec.HERE, sub), folder / sub)
    cfg = json.loads((folder / "configs" / "bal1936.json").read_text())
    cfg.update(name="bal1936r", route="no_such_route")
    (folder / "configs" / "bal1936r.json").write_text(json.dumps(cfg))
    bench["configs"].append(dict(bench["configs"][0], name="bal1936r",
                                 file=f"{pb_spec.FOLDER}/configs/bal1936r.json"))
    bench["workloads"].append({"name": "bal1936r.certify",
                               "config": "bal1936r", "traffic": "closed1",
                               "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    root = str(tmp_path)
    with pytest.raises(KeyError, match="no_such_route"):
        pb_spec.find_cell("bal1936r.certify", pb_spec.load_benchmark(root),
                          root)
    # the repository's cells name none and take the default route
    for w in bench["workloads"][:-1]:
        cell = pb_spec.find_cell(w["name"], bench)
        assert "route" not in cell.config
        assert os.path.basename(cell.route) == pb_spec.DEFAULT_ROUTE + ".py"
