"""A run's result line, its refusals, and what it loads."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import pb_tiny
import run

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device",
               "checks"]


def test_result_line_schema(monkeypatch):
    cell = pb_tiny.tiny_cell("bal1936.certify", monkeypatch)
    res = run.run_cell(cell, 2**31 + 5, 0.5, False, torch.device("cpu"),
                       log=lambda *a: None)
    assert list(res) == RESULT_KEYS          # checks comes last
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"solution_s", "solution_p90_s",
                                   "setup_s"} or set(res["metrics"]) == {
                                       "solution_s", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(res)


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = _run(["--workload", "bal1936.certify", "--seed", "1", "--seconds",
              "1", "--trace", "0"], pb_tiny.ROOT)
    assert p.returncode != 0
    assert "correct" not in p.stdout


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(os.path.join(pb_tiny.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(pb_tiny.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    p = _run(["--workload", "bal1936.certify", "--seed", "1", "--seconds",
              "1", "--trace", "0"], tmp_path, env)
    assert p.returncode != 0
    assert "correct" not in p.stdout


LOADED = """
import sys, json, torch
sys.path[:0] = [{bench!r}, {root!r}]
{body}
print(json.dumps(sorted(sys.modules)))
"""


def _loaded(body):
    code = LOADED.format(bench=pb_tiny.BENCH, root=pb_tiny.ROOT, body=body)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=pb_tiny.ROOT)
    assert p.returncode == 0, p.stderr
    return {m.split(".")[0] for m in json.loads(p.stdout.splitlines()[-1])}


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_port():
    tops = _loaded("""
import copy, run, pb_spec
cell = pb_spec.find_cell("bal1936.certify", pb_spec.load_benchmark())
cfg = copy.deepcopy(cell.config)
cfg["scene"] = dict(n_cameras=30, n_points=100, obs_per_camera=10,
                    noise=0.001)
cfg["scene_seeds"] = [3]
run.run_cell(cell._replace(config=cfg), 3, 0.1, False, torch.device("cpu"),
             log=lambda *a: None)
""")
    assert "xmtpu_torch" in tops
    assert not tops & set(run.FORBIDDEN)
    ref = _loaded("""
import numpy as np, pb_reference, pb_judge, pb_scenes
sc = pb_scenes.make_scene(10, 30, 6, 0.01, seed=1)
el = pb_reference.eliminate(sc.edges, sc.weights, sc.landmarks, sc.N, sc.M,
                            torch.float64, "cpu")
""")
    assert not ref & (set(run.FORBIDDEN) | {"xmtpu_torch"})
