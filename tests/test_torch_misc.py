"""The port's small modules against the JAX package's: the pipeline
configurations, the stdout tee, the trace hook, the dataset loaders (on
files written here) and the viewers' PLY fallback."""

import dataclasses
import json
import os

import numpy as np
import pytest

from xmtpu import config as jconfig
from xmtpu.pipeline import datasets as jds
from xmtpu.pipeline import visualization as jviz
from xmtpu_torch import config as tconfig
from xmtpu_torch.io.bin_format import save_matrix_to_bin
from xmtpu_torch.pipeline import datasets as tds
from xmtpu_torch.pipeline import visualization as tviz


@pytest.mark.parametrize("name", ["SolverConfig", "GraphConfig", "XM2Config",
                                  "DepthConfig", "PipelineConfig"])
def test_config_defaults_match(name):
    ref, port = getattr(jconfig, name)(), getattr(tconfig, name)()
    assert [f.name for f in dataclasses.fields(port)] == [
        f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_pipeline_config_rules():
    cfg = tconfig.PipelineConfig()
    assert cfg.graph.frame_min_obs == 10
    assert cfg.xm2.percentile == 90.0
    assert cfg.solver.max_time == 1000.0
    assert tconfig.PipelineConfig.adaptive_lam(500, 10) == 50.0
    assert tconfig.PipelineConfig.adaptive_lam(7, 0) == 7.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.xm2 = None


def test_tee_stdout(tmp_path, capsys):
    import sys

    from xmtpu_torch.utils.logging import Tee, tee_stdout

    log = tmp_path / "log.txt"
    before = sys.stdout
    with tee_stdout(str(log)):
        print("hello tee")
    assert sys.stdout is before
    assert log.read_text() == "hello tee\n"
    assert "hello tee" in capsys.readouterr().out
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    with open(a, "w") as fa, open(b, "w") as fb:
        t = Tee(fa, fb)
        t.write("x")
        t.flush()
    assert a.read_text() == b.read_text() == "x"


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch

    from xmtpu_torch.utils.timer import device_trace

    with device_trace(str(tmp_path / "trace")) as path:
        torch.ones(64).cumsum(0)
    assert os.path.dirname(path) == str(tmp_path / "trace")
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::cumsum") for n in names)


# --------------------------------------------------------------- datasets --

def _same(a, b):
    """Loader outputs equal, nested dicts / tuples of arrays and scalars."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif hasattr(a, "K") and hasattr(a, "model"):       # undistort.Camera
        assert (a.model, a.width, a.height) == (b.model, b.width, b.height)
        np.testing.assert_array_equal(a.params, b.params)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _quat(rng):
    q = rng.normal(size=4)
    return q / np.linalg.norm(q)


def test_bal_loader(tmp_path):
    rng = np.random.default_rng(0)
    R = np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                        for _ in range(4)], axis=1)
    save_matrix_to_bin(str(tmp_path / "gtR.bin"), R)
    save_matrix_to_bin(str(tmp_path / "gtt.bin"), rng.normal(size=(3, 4)))
    got = tds.load_BAL_gt(str(tmp_path))
    _same(got, jds.load_BAL_gt(str(tmp_path)))
    assert len(got) == 4
    np.testing.assert_allclose(got[2]["R"] @ got[2]["R"].T, np.eye(3),
                               atol=1e-12)
    _same(tds.load_BAL_camera(str(tmp_path)),
          jds.load_BAL_camera(str(tmp_path)))


def test_replica_loader(tmp_path):
    rng = np.random.default_rng(1)
    poses = []
    for _ in range(3):
        T = np.eye(4)
        T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        T[:3, 3] = rng.normal(size=3)
        poses.append(T.ravel())
    np.savetxt(tmp_path / "traj.txt", np.array(poses))
    got = tds.load_replica_gt(str(tmp_path))
    _same(got, jds.load_replica_gt(str(tmp_path)))
    assert sorted(got) == [f"frame{i:06d}.jpg" for i in range(3)]
    _same(tds.load_replica_camera(""), jds.load_replica_camera(""))


def test_tum_loader(tmp_path):
    rng = np.random.default_rng(2)
    (tmp_path / "images").mkdir()
    for ts in ("0.5", "1.25", "2.0", "9.0"):
        (tmp_path / "images" / f"{ts}.png").write_bytes(b"")
    rows = [[t, *rng.normal(size=3), *_quat(rng)] for t in (0.75, 1.5, 2.5)]
    with open(tmp_path / "groundtruth.txt", "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for r in rows:
            f.write(" ".join(repr(float(x)) for x in r) + "\n")
    got = tds.load_tum_gt(str(tmp_path))
    _same(got, jds.load_tum_gt(str(tmp_path)))
    assert len(got) == 4
    _same(tds.load_tum_camera(""), jds.load_tum_camera(""))


def _colmap_text(path):
    path.mkdir(exist_ok=True)
    (path / "cameras.txt").write_text(
        "# comment\n1 PINHOLE 640 480 500 501 320 240\n"
        "2 SIMPLE_RADIAL 800 600 700 400 300 0.01\n"
        "3 OPENCV 640 480 500 501 320 240 0.1 -0.02 0.001 0.002\n")
    (path / "images.txt").write_text(
        "# comment\n1 1 0 0 0 0.1 0.2 0.3 1 img1.jpg\n0 0 0\n"
        "2 0.9 0.1 -0.3 0.2 1.0 -2.0 0.5 2 img2.jpg\n\n"
        "3 0.5 0.5 0.5 0.5 0 0 1 3 img3.jpg\n1 2 3 4 5 6\n")


def test_colmap_text_loaders(tmp_path):
    _colmap_text(tmp_path / "sparse")
    for name in ("load_colmap_camera", "load_colmap_gt"):
        _same(getattr(tds, name)(str(tmp_path)),
              getattr(jds, name)(str(tmp_path)))
    cams = str(tmp_path / "sparse" / "cameras.txt")
    for name in ("load_camera_data", "load_camera_models"):
        _same(getattr(tds, name)(cams), getattr(jds, name)(cams))
    images = str(tmp_path / "sparse" / "images.txt")
    _same(tds.load_image_data(images), jds.load_image_data(images))
    gt = tds.load_colmap_gt(str(tmp_path))
    np.testing.assert_allclose(gt["img1.jpg"]["R"], np.eye(3), atol=1e-12)
    assert tds.load_camera_models(cams)[2].model == "SIMPLE_RADIAL"


def test_gt_depth_loader(tmp_path):
    _colmap_text(tmp_path)
    rng = np.random.default_rng(3)
    rows = np.column_stack([np.repeat([1, 3, 7], 4), rng.random((12, 2)) * 100,
                            np.zeros(12), rng.random(12) * 5])
    save_matrix_to_bin(str(tmp_path / "depth_gt.bin"), rows)
    got = tds.load_gt_depth(str(tmp_path))
    _same(got, jds.load_gt_depth(str(tmp_path)))
    assert sorted(got) == ["img1.jpg", "img3.jpg"]       # id 7 is unknown


# ------------------------------------------------------------- viewers --

def _extrinsics(n=3):
    rng = np.random.default_rng(4)
    out = []
    for _ in range(n):
        T = np.eye(4)
        T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        T[:3, 3] = rng.normal(size=3)
        out.append(T)
    return out


@pytest.mark.parametrize("viewer", ["visualize_camera", "visualize",
                                    "visualize, colors"])
def test_viewers_write_the_reference_ply(viewer, tmp_path, monkeypatch,
                                         capsys):
    """Without open3d both packages write ``xmtpu_viz_*.ply`` in the working
    directory: the same bytes."""
    if tviz._HAS_O3D:
        pytest.skip("open3d is installed: the viewers open a window")
    rng = np.random.default_rng(5)
    ext = _extrinsics()
    pts = rng.normal(size=(20, 3))
    cols = rng.random((20, 3)) if viewer.endswith("colors") else None
    files = {}
    for tag, mod in (("ref", jviz), ("port", tviz)):
        (tmp_path / tag).mkdir()
        monkeypatch.chdir(tmp_path / tag)
        if viewer == "visualize_camera":
            mod.visualize_camera(ext, scale=0.2)
        else:
            mod.visualize(ext, pts, cols)
        files[tag] = {p: (tmp_path / tag / p).read_bytes()
                      for p in sorted(os.listdir(tmp_path / tag))}
    assert files["port"] == files["ref"]
    want = {"xmtpu_viz_cameras.ply"} | (
        set() if viewer == "visualize_camera" else {"xmtpu_viz_points.ply"})
    assert set(files["port"]) == want
    out = capsys.readouterr().out
    assert out.count("open3d not available") == 2
