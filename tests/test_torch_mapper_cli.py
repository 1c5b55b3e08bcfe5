"""The global mapper and the command line (``pipeline/global_mapper.py``,
``__main__.py``): ``xmtpu_torch`` with ``device="cpu"`` against ``xmtpu``.

The mapper's stages 0-4 give equal ``MapperResult`` arrays (its compute
stages agree far inside the pair filter's 10 degree margin, the rest is
numpy) and equal tempdata files.  Every subcommand returns the same code
and prints the same status and rank; primals agree within 1e-8 and the
written ``R.bin``/``s.bin`` within 1e-6.  Stages 5-8 are not ported: a flag
that turns one on raises ``NotImplementedError``.
"""

import filecmp
import os
import shutil

import numpy as np
import pytest

import chip_smoke
from tests.test_colmap_db import _ring_scene, _write_scene_db
from xmtpu.__main__ import main as j_main
from xmtpu.pipeline import colmap_db as jdb
from xmtpu.pipeline import global_mapper as jgm
from xmtpu_torch.__main__ import main as t_main
from xmtpu_torch.pipeline import colmap_db as tdb
from xmtpu_torch.pipeline import global_mapper as tgm

TEMPDATA = ("output.txt", "filename.txt", "relative_pose.txt")
SMALL_D = dict(n_frames=24, n_points=1000, seed=0)


def _ring_db(tmp_path, seed=7, n_cams=8, n_pts=50):
    rng = np.random.default_rng(seed)
    R, t, pts, keypoints, K = _ring_scene(rng, n_cams=n_cams, n_pts=n_pts)
    db = str(tmp_path / "database.db")
    _write_scene_db(db, R, t, keypoints, 500.0, 640, 480)
    return db


def _focal_db(tmp_path):
    """``tests/test_colmap_db.py``'s self-calibration database: general
    position relative poses, F only, no prior focal."""
    from xmtpu.pipeline.calibration import fundamental_from_pose
    from xmtpu.pipeline.undistort import Camera

    rng = np.random.default_rng(3)
    f, w, h = 500.0, 640, 480
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    cameras = {1: Camera(model="SIMPLE_PINHOLE", params=[420.0, w / 2, h / 2],
                         width=w, height=h)}
    images = {i + 1: (f"img{i:03d}.png", 1) for i in range(6)}
    kps = {i + 1: rng.random((10, 2)) * [w, h] for i in range(6)}
    tvgs = {}
    for i in range(6):
        for j in range(i + 1, 6):
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            a = 0.2 + 0.4 * rng.random()
            Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                           [-axis[1], axis[0], 0]])
            Rij = np.eye(3) + np.sin(a) * Kx + (1 - np.cos(a)) * Kx @ Kx
            tij = rng.normal(size=3)
            tvgs[(i + 1, j + 1)] = {
                "matches": np.stack([np.arange(10)] * 2, axis=1),
                "config": jdb.UNCALIBRATED,
                "F": fundamental_from_pose(K, K, Rij,
                                           tij / np.linalg.norm(tij))}
    db = str(tmp_path / "focal.db")
    jdb.write_database(db, cameras, images, keypoints=kps,
                       two_view_geometries=tvgs, prior_focal={1: False})
    return db


def _scene_d_db(tmp_path, **kw):
    sc = chip_smoke.make_scene_d(**{**SMALL_D, **kw})
    db = str(tmp_path / "scene_d.db")
    chip_smoke.write_scene_d(db, sc)
    return db, sc


def _assert_same_result(a, b):
    assert a._fields == b._fields
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if name == "image_names":
            assert x == y
        elif x is None or y is None:
            assert x is None and y is None, name
        else:
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                          err_msg=name)


def _solve_both(db, j_opts, t_opts):
    vj = jdb.database_to_view_graph(jdb.read_database(db))
    vt = tdb.database_to_view_graph(tdb.read_database(db))
    return (jgm.global_mapper_solve(vj, j_opts),
            tgm.global_mapper_solve(vt, t_opts, device="cpu"), vj, vt)


@pytest.mark.parametrize("scene", ["ring", "scene_d"])
def test_global_mapper_solve_matches(tmp_path, scene):
    db = (_ring_db(tmp_path) if scene == "ring"
          else _scene_d_db(tmp_path)[0])
    rj, rt, _, _ = _solve_both(db, jgm.GlobalMapperOptions(),
                               tgm.GlobalMapperOptions())
    _assert_same_result(rj, rt)
    assert rt.registered.all() and rt.n_tracks > 0


def test_scene_d_mapper_drops_the_corrupted_pairs(tmp_path):
    db, sc = _scene_d_db(tmp_path)
    _, rt, _, vt = _solve_both(db, jgm.GlobalMapperOptions(),
                               tgm.GlobalMapperOptions())
    np.testing.assert_array_equal(vt.pairs, sc.pairs)
    assert sc.corrupted.any()
    np.testing.assert_array_equal(rt.pair_valid, ~sc.corrupted)
    for p in np.flatnonzero(rt.pair_valid):
        i, j = sc.pairs[p]
        np.testing.assert_allclose(rt.R_rel[p], sc.R[j] @ sc.R[i].T, rtol=0,
                                   atol=1e-4)


def test_mapper_with_an_isolated_image_raises_as_the_reference(tmp_path):
    """At 600 points frame 14 of the small scene D shares too few points
    to get a pair; stage 3 averages over every image and both packages
    stop with the same error (the reference's behaviour, kept)."""
    db, sc = _scene_d_db(tmp_path, n_points=600)
    assert 14 not in sc.pairs
    vj = jdb.database_to_view_graph(jdb.read_database(db))
    vt = tdb.database_to_view_graph(tdb.read_database(db))
    with pytest.raises(ValueError, match="not connected"):
        jgm.global_mapper_solve(vj)
    with pytest.raises(ValueError, match="not connected"):
        tgm.global_mapper_solve(vt, device="cpu")


@pytest.mark.parametrize("skip", [
    dict(skip_relative_pose_estimation=True),
    dict(skip_preprocessing=True, min_num_view_per_track=2),
    dict(min_num_tracks_per_view=5),
    dict(skip_rotation_averaging=True, skip_track_establishment=True)])
def test_global_mapper_options_match(tmp_path, skip):
    db = _ring_db(tmp_path, n_cams=6, n_pts=40)
    rj, rt, _, _ = _solve_both(db, jgm.GlobalMapperOptions(**skip),
                               tgm.GlobalMapperOptions(**skip))
    _assert_same_result(rj, rt)


def test_view_graph_calibration_stage_matches(tmp_path):
    opts = dict(skip_relative_pose_estimation=True,
                skip_rotation_averaging=True, skip_track_establishment=True)
    rj, rt, _, _ = _solve_both(_focal_db(tmp_path),
                               jgm.GlobalMapperOptions(**opts),
                               tgm.GlobalMapperOptions(**opts))
    np.testing.assert_allclose(rt.focals, rj.focals, rtol=1e-9)
    np.testing.assert_array_equal(rt.pair_valid, rj.pair_valid)
    assert rt.focals[0] == pytest.approx(500.0, rel=0.05)


def test_export_tempdata_files_equal(tmp_path):
    db = _ring_db(tmp_path)
    rj, rt, vj, vt = _solve_both(db, jgm.GlobalMapperOptions(),
                                 tgm.GlobalMapperOptions())
    jgm.export_tempdata(rj, vj, str(tmp_path / "j"))
    tgm.export_tempdata(rt, vt, str(tmp_path / "t"))
    for name in TEMPDATA:
        assert filecmp.cmp(tmp_path / "j" / name, tmp_path / "t" / name,
                           shallow=False), name


@pytest.mark.parametrize("flags", [
    [],
    ["--TrackEstablishment.max_num_view_per_track", "1000000", "--quiet"],
    ["--max-num-view-per-track", "7", "--min-num-view-per-track", "2",
     "--Thresholds.min_inlier_num", "10", "--skip-view-graph-calibration",
     "--image_path", "unused", "--GlobalPositioning.optimize_positions", "0",
     "--BundleAdjustment.max_num_iterations", "3",
     "--Triangulation.min_angle", "2.0"],
    ["--ViewGraphCalib.thres_two_view_error", "1.5",
     "--RelPoseEstimation.max_epipolar_error", "2.0",
     "--Thresholds.max_rotation_error", "5", "--skip_pruning", "1"],
    ["--ba_iteration_num", "5", "--retriangulation_iteration_num", "2"]])
def test_mapper_subcommand_matches(tmp_path, flags, capsys):
    db = _ring_db(tmp_path)
    out = {}
    for tag, main, kw in (("j", j_main, {}), ("t", t_main,
                                                {"device": "cpu"})):
        path = str(tmp_path / tag)
        assert main(["mapper", "--database_path", db, "--output_path",
                     path] + flags, **kw) == 0
        out[tag] = [ln for ln in capsys.readouterr().out.splitlines()
                    if ln.startswith("mapper:")]
    assert out["j"][0].split("->")[0] == out["t"][0].split("->")[0]
    for name in TEMPDATA:
        assert filecmp.cmp(tmp_path / "j" / name, tmp_path / "t" / name,
                           shallow=False), name


@pytest.mark.parametrize("flag", ["skip_global_positioning",
                                  "skip_bundle_adjustment",
                                  "skip_retriangulation", "skip_pruning"])
def test_tail_stage_flags_raise(tmp_path, flag):
    db = _ring_db(tmp_path, n_cams=4, n_pts=20)
    with pytest.raises(NotImplementedError, match="item 13"):
        t_main(["mapper", "--database_path", db, "--output_path",
                str(tmp_path / "out"), "--" + flag, "0"], device="cpu")
    assert not (tmp_path / "out").exists()
    vg = tdb.database_to_view_graph(tdb.read_database(db))
    with pytest.raises(NotImplementedError, match="stages 5-8"):
        tgm.global_mapper_solve(vg, tgm.GlobalMapperOptions(**{flag: False}),
                                device="cpu")


@pytest.fixture(scope="module")
def qdir(tmp_path_factory):
    """``Q.bin`` and ``Abar.bin`` of ``make_scene(n_cameras=8)``."""
    from xmtpu.assembly.creatematrix import create_matrix
    from xmtpu.pipeline.synthetic import make_scene

    d = tmp_path_factory.mktemp("q")
    sc = make_scene(n_cameras=8)
    create_matrix(sc.weights, sc.edges, sc.landmarks, str(d))
    return d


def _copy(qdir, dst):
    dst.mkdir()
    for f in os.listdir(qdir):
        shutil.copy(qdir / f, dst / f)
    return dst


def _status(text):
    line = next(ln for ln in text.splitlines() if ln.startswith("status="))
    fields = dict(kv.split("=") for kv in line.split())
    return fields


@pytest.mark.parametrize("cmd", ["solve", "solve-rank3"])
def test_solve_subcommands_match(qdir, tmp_path, cmd, capsys):
    from xmtpu.io.bin_format import load_matrix_from_bin

    res = {}
    for tag, main, kw in (("j", j_main, {}), ("t", t_main,
                                                {"device": "cpu"})):
        d = _copy(qdir, tmp_path / tag)
        rc = main([cmd, str(d), "--max-rank", "5", "--tol", "1e-8"], **kw)
        res[tag] = (rc, _status(capsys.readouterr().out),
                    load_matrix_from_bin(str(d / "R.bin"))[0],
                    load_matrix_from_bin(str(d / "s.bin"))[0])
    (rc_j, st_j, R_j, s_j), (rc_t, st_t, R_t, s_t) = res["j"], res["t"]
    assert rc_t == rc_j == 0
    for k in ("status", "certified", "rank"):
        assert st_t[k] == st_j[k], k
    assert abs(float(st_t["primal"]) - float(st_j["primal"])) <= 1e-8
    np.testing.assert_allclose(R_t, R_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("cmd", ["recover", "certify", "info"])
def test_file_subcommands_match(qdir, tmp_path, cmd, capsys):
    d = _copy(qdir, tmp_path / "d")
    assert j_main(["solve", str(d), "--max-rank", "5", "--tol", "1e-8"]) == 0
    capsys.readouterr()
    argv = {"recover": ["recover", str(d), "--ply", None],
            "certify": ["certify", str(d)],
            "info": ["info", str(d / "Q.bin")]}[cmd]
    outs = {}
    for tag, main, kw in (("j", j_main, {}), ("t", t_main,
                                                {"device": "cpu"})):
        args = [str(tmp_path / tag) if a is None else a for a in argv]
        rc = main(args, **kw)
        outs[tag] = (rc, capsys.readouterr().out)
    assert outs["t"][0] == outs["j"][0]
    if cmd == "certify":
        assert outs["t"][0] == 0            # the solve above certified
    else:
        assert outs["t"][0] == 0
        key = "recovered" if cmd == "recover" else "Q.bin:"
        pick = [[ln for ln in o.splitlines() if key in ln] for _, o in
                outs.values()]
        assert pick[0] == pick[1] and pick[0]
    if cmd == "recover":
        for part in ("_cameras.ply", "_points.ply"):
            a, b = (open(str(tmp_path / tag) + part).read().split()
                    for tag in "jt")
            assert len(a) == len(b)
            na = np.array([float(x) for x in a if _num(x)])
            nb = np.array([float(x) for x in b if _num(x)])
            np.testing.assert_allclose(nb, na, rtol=0, atol=1e-6)


def _num(x):
    try:
        float(x)
        return True
    except ValueError:
        return False
