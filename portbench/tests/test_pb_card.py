"""On the card: each cell runs a short window and comes out correct, and
the traced run reports the cell's per-layer metrics."""

import json
import subprocess
import sys

import pytest
import torch

import pb_tiny
import pb_spec


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  pb_spec.load_benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", "2147483659", "--seconds", "5",
                        "--trace", str(trace)], cwd=pb_tiny.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    want = pb_spec.find_cell(cell, pb_spec.load_benchmark())
    names = [m["name"] for m in (want.per_layer if trace else
                                 want.end_to_end)]
    assert set(res["metrics"]) == set(names)
