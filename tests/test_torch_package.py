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
           "xmtpu_torch.pipeline.synthetic",
           "xmtpu_torch.assembly.creatematrix",
           "xmtpu_torch.solver.certificate", "xmtpu_torch.solver.checkpoint",
           "xmtpu_torch.solver.staircase", "xmtpu_torch.solver.trust_region",
           "chip_smoke"]


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
                                   "certify", "trust_region_solve"])
def test_entry_points_without_device_raise(entry, tmp_path, no_card):
    import xmtpu_torch

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
    }
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
