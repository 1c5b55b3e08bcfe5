"""Package rules of the PyTorch port: it never loads JAX or ``xmtpu``, its
entry points refuse to fall back to the host when no card is present, and
``chip_smoke.py`` fails without a card.
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "xmtpu_torch")

MODULES = ["xmtpu_torch", "xmtpu_torch.XM", "xmtpu_torch.config",
           "xmtpu_torch.convert", "xmtpu_torch._build",
           "xmtpu_torch.ops.fused_tcg", "xmtpu_torch.ops.lanczos",
           "xmtpu_torch.ops.manifold", "xmtpu_torch.ops.qop",
           "xmtpu_torch.ops.schurq", "xmtpu_torch.ops.segsum",
           "xmtpu_torch.pipeline.graph", "xmtpu_torch.pipeline.recover",
           "xmtpu_torch.pipeline.synthetic", "xmtpu_torch.pipeline.xm2",
           "xmtpu_torch.runtime", "xmtpu_torch.utils.timer",
           "xmtpu_torch.assembly.creatematrix",
           "xmtpu_torch.solver.certificate", "xmtpu_torch.solver.checkpoint",
           "xmtpu_torch.solver.staircase", "xmtpu_torch.solver.trust_region",
           "xmtpu_torch.__main__", "xmtpu_torch.ops.l1",
           "xmtpu_torch.pipeline.calibration",
           "xmtpu_torch.pipeline.colmap_db", "xmtpu_torch.pipeline.colmap_io",
           "xmtpu_torch.pipeline.frontend",
           "xmtpu_torch.pipeline.global_mapper",
           "xmtpu_torch.pipeline.manipulation", "xmtpu_torch.pipeline.metrics",
           "xmtpu_torch.pipeline.refine",
           "xmtpu_torch.pipeline.rotation_averaging",
           "xmtpu_torch.pipeline.undistort", "xmtpu_torch.pipeline.viewgraph",
           "xmtpu_torch.pipeline.visualization", "chip_smoke"]


def _run(code, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_leaves_jax_and_xmtpu_out():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'xmtpu' or m.startswith('xmtpu.'))\n"
            "print(bad)\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_name_no_jax_or_xmtpu_import():
    pat = re.compile(r"^\s*(import jax|from jax|import xmtpu\b(?!_torch)|"
                     r"from xmtpu\b(?!_torch))", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(PORT):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_tf32_is_off():
    import xmtpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")


def _tiny(tmp_path):
    from xmtpu_torch.io.bin_format import save_matrix_to_bin
    from xmtpu_torch.pipeline.synthetic import make_scene

    sc = make_scene(n_cameras=4, n_points=20, obs_per_camera=10, seed=0)
    save_matrix_to_bin(str(tmp_path / "Q.bin"), np.eye(12))
    save_matrix_to_bin(str(tmp_path / "s_ini.bin"), np.ones((4, 1)))
    return sc


@pytest.mark.parametrize("entry", ["solve_arrays", "solve", "solve_with_init",
                                   "solve_rank3", "create_matrix_arrays",
                                   "certify", "trust_region_solve",
                                   "SchurQ.build", "xm2_solve",
                                   "main solve", "main solve-rank3",
                                   "main recover", "main certify",
                                   "main mapper", "global_mapper_solve",
                                   "calibrate_view_graph",
                                   "rotation_averaging", "filter_pairs",
                                   "l1_solve_dense"])
def test_entry_points_without_device_raise(entry, tmp_path, no_card):
    import xmtpu_torch
    from xmtpu_torch.__main__ import main
    from xmtpu_torch.ops.l1 import l1_solve_dense
    from xmtpu_torch.ops.schurq import SchurQ
    from xmtpu_torch.pipeline.calibration import calibrate_view_graph
    from xmtpu_torch.pipeline.colmap_db import ViewGraphData
    from xmtpu_torch.pipeline.global_mapper import global_mapper_solve
    from xmtpu_torch.pipeline.rotation_averaging import (filter_pairs,
                                                         rotation_averaging)
    from xmtpu_torch.pipeline.xm2 import xm2_solve

    sc = _tiny(tmp_path)
    calls = {
        "solve_arrays": lambda: xmtpu_torch.solve_arrays(np.eye(12)),
        "solve": lambda: xmtpu_torch.solve(str(tmp_path)),
        "solve_with_init": lambda: xmtpu_torch.solve_with_init(str(tmp_path)),
        "solve_rank3": lambda: xmtpu_torch.solve_rank3(str(tmp_path)),
        "create_matrix_arrays": lambda: xmtpu_torch.create_matrix_arrays(
            sc.weights, sc.edges, sc.landmarks),
        "certify": lambda: xmtpu_torch.certify(np.eye(12), np.ones((12, 3)),
                                               0.0, 1.0),
        "trust_region_solve": lambda: xmtpu_torch.trust_region_solve(
            np.eye(12), np.broadcast_to(np.eye(3), (4, 3, 3)), np.ones(4)),
        "SchurQ.build": lambda: SchurQ.build(sc.weights, sc.edges,
                                             sc.landmarks),
        "xm2_solve": lambda: xm2_solve(sc.edges, sc.weights, sc.landmarks,
                                       sc.rgbs, sc.N, sc.M, implicit=True,
                                       verbose=False),
        "global_mapper_solve": lambda: global_mapper_solve(
            ViewGraphData(*([None] * len(ViewGraphData._fields)))),
        "calibrate_view_graph": lambda: calibrate_view_graph(
            np.eye(3)[None], [0], [0], [[0.0, 0.0]], [1.0]),
        "rotation_averaging": lambda: rotation_averaging(
            np.array([[0, 1]]), np.eye(3)[None], 2),
        "filter_pairs": lambda: filter_pairs(np.array([[0, 1]]),
                                             np.eye(3)[None], 2),
        "l1_solve_dense": lambda: l1_solve_dense(np.eye(2), np.ones(2)),
    }
    for cmd in ("solve", "solve-rank3", "recover", "certify"):
        calls[f"main {cmd}"] = lambda cmd=cmd: main([cmd, str(tmp_path)])
    calls["main mapper"] = lambda: main([
        "mapper", "--database_path", str(tmp_path / "database.db"),
        "--output_path", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert not (tmp_path / "R.bin").exists()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card(alone, tmp_path, no_card):
    """No card, or a directory holding ``chip_smoke.py`` and nothing else of
    the repository: a non-zero exit and no result line."""
    cwd = ROOT
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_python_dash_m_without_card_fails(tmp_path, no_card):
    """``python -m xmtpu_torch`` offers the six subcommands and, with no
    card, fails instead of running on the host."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-m", "xmtpu_torch", "--help"],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0
    for cmd in ("info", "solve", "solve-rank3", "recover", "certify",
                "mapper"):
        assert cmd in out.stdout
    out = subprocess.run([sys.executable, "-m", "xmtpu_torch", "mapper",
                          "--database_path", str(tmp_path / "db"),
                          "--output_path", str(tmp_path / "out")],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert not (tmp_path / "out").exists()
