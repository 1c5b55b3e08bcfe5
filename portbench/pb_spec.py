"""Finds a cell and everything it names, by name, in files of their own.

``BENCHMARK.json`` (at the checkout's root) lists the cells, metrics and
configurations.  A configuration is ``configs/<name>.json`` (its file is
named in ``BENCHMARK.json``), a traffic mix is ``traffic/<name>.json``, a
metric is read by ``metrics/<name>.py``, a module with ``read(run)``, and
the request a configuration serves is ``routes/<name>.py``, named by the
configuration's ``"route"`` key (:data:`DEFAULT_ROUTE` without one).  A
later cell, traffic mix, metric or route is new files and entries: nothing
here changes.

A route module provides (``routes/certify.py`` is the default and its
docstring the full contract):

- ``scenes(config)``: the configuration's fixed scenes;
- ``setup(scene, config, device)``: what set-up holds for a scene, built
  under ``run.Memory.build``;
- ``request(k, held, config, device)``: one served request of scene ``k``,
  run under ``run.Memory.solve``; a ``pb_program.Solution`` with its walls,
  every ``SolveResult`` it ran, and its outputs to judge
  (``pb_judge.Judged``: each with its observation set and ``lam``);
- ``judge(scenes, held, sols, config, seed, device, control_dtype=None,
  log=print)``: ``(worst, failed, control)`` after the window, ``held``
  freed before the reference runs; with ``control_dtype`` the control's
  worst readings too (``control.py``);
- ``CHECKS``: the route's own checks, beside ``pb_judge.CHECKS``; each is
  listed in the configuration's ``limits``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FOLDER = os.path.basename(HERE)
DEFAULT_ROUTE = "certify"


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list
    route: str            # the path of the route module its config names


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
    # a route is the harness's code, found beside its modules, as they are
    route = config.get("route", DEFAULT_ROUTE)
    route_file = os.path.join(HERE, "routes", route + ".py")
    if os.path.basename(route) != route or not os.path.isfile(route_file):
        raise KeyError(f"configuration {conf['name']!r} names route "
                       f"{route!r}: no {FOLDER}/routes/{route}.py")
    with open(os.path.join(root, FOLDER, "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)],
                route_file)


def _module(path: str, prefix: str):
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: str = ROOT):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return _module(os.path.join(root, FOLDER, "metrics", metric + ".py"),
                   "pb_metric_").read


def load_route(cell: Cell):
    """The route module of ``cell``; a check of its own that the
    configuration's ``limits`` do not list is refused here, before set-up."""
    mod = _module(cell.route, "pb_route_")
    missing = [c for c in mod.CHECKS if c not in cell.config["limits"]]
    if missing:
        raise KeyError(f"route {cell.route} checks {missing}: not in "
                       f"{cell.config['name']!r}'s limits")
    return mod
