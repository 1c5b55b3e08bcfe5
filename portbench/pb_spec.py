"""Finds a cell and everything it names, by name, in files of their own.

``BENCHMARK.json`` (at the checkout's root) lists the cells, metrics and
configurations.  A configuration is ``configs/<name>.json`` (its file is
named in ``BENCHMARK.json``), a traffic mix is ``traffic/<name>.json`` and a
metric is read by ``metrics/<name>.py``, a module with ``read(run)``.  A
later cell, traffic mix or metric is new files and entries: nothing here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FOLDER = os.path.basename(HERE)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: dict, root: str = ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, FOLDER, "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def reader(metric: str, root: str = ROOT):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(root, FOLDER, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "pb_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
