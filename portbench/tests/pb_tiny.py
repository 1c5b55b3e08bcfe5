"""Small cells for the benchmark's CPU tests: the repository's cells with
their scenes cut to a size a test run holds."""

from __future__ import annotations

import copy
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (BENCH, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import pb_spec  # noqa: E402

SCENES = {
    "bal1936.certify": dict(n_cameras=40, n_points=160, obs_per_camera=12,
                            noise=0.001),
}

# paths through the harness that no cell takes yet, served as
# ``bal1936.certify`` is: the saddle escape on a small, very noisy scene
# (solved as the repository's scene A is), and XM^2's implicit pass on a
# small window scene
ESCAPE = {
    "name": "escape_small", "generator": "make_scene",
    "scene": dict(n_cameras=30, n_points=100, obs_per_camera=10, noise=0.35),
    "scene_seeds": [0, 1], "operator": "dense", "assembly_precision": "f64",
    "solve": {"max_rank": 6, "tol": 1e-6, "precision": "mixed",
              "inner_f32": True},
    "limits": {"cert_bound": 0.0001, "cert_gap": 0.001, "failed": 0,
               "op_err": 1e-10, "primal_err": 1e-9, "cert": 1.0,
               "rot_err": 1e-9, "scale_err": 1e-9, "pos_err": 3e-9},
}
SCHURQ = {
    "name": "window_small", "generator": "make_scene_window",
    "scene": dict(n_cameras=60, n_points=240, obs_per_camera=12,
                  noise=0.001, long_range=4),
    "scene_seeds": [0, 1], "operator": "schurq",
    "solve": {"max_rank": 5, "tol": 0.1, "lam": 0.0, "precision": "mixed",
              "inner_f32": True, "edge_tf": True},
    "limits": {"cert_bound": 0.001, "cert_gap": 0.001, "failed": 0,
               "op_err": 1e-10, "primal_err": 1e-5, "cert": 1.0,
               "rot_err": 1e-9, "scale_err": 1e-9, "pos_err": 1e-8},
}
EXTRA = {"escape": ESCAPE, "schurq": SCHURQ}


def tiny_cell(name: str, monkeypatch) -> pb_spec.Cell:
    """The cell ``name`` with a small scene, two of them a run
    (``"escape"``, ``"schurq"``: :data:`ESCAPE`, :data:`SCHURQ` served as
    ``bal1936.certify`` is, the latter kept implicit by a 1-byte dense
    budget)."""
    base = pb_spec.find_cell("bal1936.certify", pb_spec.load_benchmark())
    if name == "schurq":
        monkeypatch.setenv("XMTPU_DENSE_BUDGET", "1")
    else:
        monkeypatch.delenv("XMTPU_DENSE_BUDGET", raising=False)
    if name in EXTRA:
        return base._replace(name=name, config=copy.deepcopy(EXTRA[name]))
    cell = pb_spec.find_cell(name, pb_spec.load_benchmark())
    cfg = copy.deepcopy(cell.config)
    cfg["scene"], cfg["scene_seeds"] = SCENES[name], cfg["scene_seeds"][:2]
    return cell._replace(config=cfg)
