"""Every name in BENCHMARK.json resolves to its own files, and a cell added
as data files alone is found."""

import json
import os
import shutil

import pytest

import pb_tiny  # noqa: F401  (puts the benchmark on the path)
import pb_spec


def test_every_cell_and_metric_resolves():
    bench = pb_spec.load_benchmark()
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(pb_spec.reader(m["name"]))
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = pb_spec.find_cell(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert cell.config["reduced"] == configs[w["config"]]["reduced"]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert any(e["name"] == m["moves"] for e in cell.end_to_end)
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(configs)


def test_a_cell_added_as_data_is_found(tmp_path):
    bench = pb_spec.load_benchmark()
    folder = tmp_path / pb_spec.FOLDER
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(pb_spec.HERE, sub), folder / sub)
    cfg = json.loads((folder / "configs" / "bal1936.json").read_text())
    cfg["name"] = "bal1936x"
    (folder / "configs" / "bal1936x.json").write_text(json.dumps(cfg))
    (folder / "traffic" / "burst.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "order": "cycle"}))
    (folder / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return 1.5\n")
    bench["configs"].append(dict(bench["configs"][0], name="bal1936x",
                                 file=f"{pb_spec.FOLDER}/configs/bal1936x.json"))
    bench["workloads"].append({"name": "bal1936x.burst", "config": "bal1936x",
                               "traffic": "burst", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "new_metric", "unit": "%",
                               "better": "lower", "source": "host_clock",
                               "layer": "device", "moves": "solution_s",
                               "workloads": ["bal1936x.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    root = str(tmp_path)
    cell = pb_spec.find_cell("bal1936x.burst", pb_spec.load_benchmark(root),
                             root)
    assert cell.config["name"] == "bal1936x"
    assert cell.traffic["order"] == "cycle"
    assert [m["name"] for m in cell.per_layer][-1] == "new_metric"
    assert pb_spec.reader("new_metric", root)(None) == 1.5
    with pytest.raises(KeyError):
        pb_spec.find_cell("no.such", pb_spec.load_benchmark(root), root)
