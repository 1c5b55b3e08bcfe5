"""COLMAP database I/O of the mapper (``pipeline/colmap_db.py``):
``xmtpu_torch`` against ``xmtpu``.  A database written by either package
reads back in the other to the same contents, and
``database_to_view_graph`` gives equal fields (exact: the module is a numpy
copy)."""

import sqlite3

import numpy as np
import pytest

from xmtpu.pipeline import colmap_db as jdb
from xmtpu.pipeline.undistort import Camera as JCamera
from xmtpu_torch.pipeline import colmap_db as tdb
from xmtpu_torch.pipeline.undistort import Camera as TCamera


def _contents(Camera, cdb, seed):
    """A small two-camera database: keypoints, raw matches and two-view
    geometries of every config family, one of them a bad config."""
    rng = np.random.default_rng(seed)
    cameras = {1: Camera(model="SIMPLE_RADIAL",
                         params=[500.0, 320.0, 240.0, -0.05], width=640,
                         height=480),
               3: Camera(model="PINHOLE", params=[610.0, 600.0, 400.0, 300.0],
                         width=800, height=600)}
    images = {i: (f"img{i:03d}.jpg", 1 if i % 2 else 3) for i in range(1, 7)}
    keypoints = {i: rng.uniform(0, 600, size=(40 + i, 2)) for i in images}
    configs = [cdb.CALIBRATED, cdb.UNCALIBRATED, cdb.PLANAR,
               cdb.WATERMARK, cdb.CALIBRATED]
    tvgs, raw = {}, {}
    k = 0
    for i in range(1, 7):
        for j in range(i + 1, 7):
            if rng.random() < 0.3:
                continue
            m = rng.integers(0, 40, size=(rng.integers(5, 30), 2))
            # an out-of-range index in one pair (dropped on conversion)
            if k == 2:
                m[0, 0] = 999
            key = (j, i) if k % 3 == 0 else (i, j)
            raw[key] = m
            tv = {"matches": m, "config": configs[k % len(configs)]}
            for name in ("F", "E", "H"):
                if rng.random() < 0.7:
                    tv[name] = rng.normal(size=(3, 3))
            tvgs[key] = tv
            k += 1
    return dict(cameras=cameras, images=images, keypoints=keypoints,
                matches=raw, two_view_geometries=tvgs,
                prior_focal={1: True, 3: False})


def _assert_same_db(a, b):
    assert sorted(a.cameras) == sorted(b.cameras)
    for c in a.cameras:
        ca, cb = a.cameras[c], b.cameras[c]
        assert (ca.model, ca.width, ca.height, ca.has_prior_focal_length) \
            == (cb.model, cb.width, cb.height, cb.has_prior_focal_length)
        np.testing.assert_array_equal(ca.params, cb.params)
    assert a.prior_focal == b.prior_focal
    assert sorted(a.images) == sorted(b.images)
    for i in a.images:
        ia, ib = a.images[i], b.images[i]
        assert (ia.image_id, ia.name, ia.camera_id) \
            == (ib.image_id, ib.name, ib.camera_id)
        np.testing.assert_array_equal(ia.keypoints, ib.keypoints)
    assert sorted(a.pairs) == sorted(b.pairs)
    for key in a.pairs:
        pa, pb = a.pairs[key], b.pairs[key]
        assert (pa.image_id1, pa.image_id2, pa.config) \
            == (pb.image_id1, pb.image_id2, pb.config)
        np.testing.assert_array_equal(pa.matches, pb.matches)
        for name in ("F", "E", "H"):
            x, y = getattr(pa, name), getattr(pb, name)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("writer", ["xmtpu", "xmtpu_torch"])
@pytest.mark.parametrize("tvg", [True, False])
def test_database_round_trip_across_packages(tmp_path, seed, writer, tvg):
    """Written by one package, read by both: the same database."""
    path = str(tmp_path / "database.db")
    if writer == "xmtpu":
        jdb.write_database(path, **_contents(JCamera, jdb, seed))
    else:
        tdb.write_database(path, **_contents(TCamera, tdb, seed))
    a = jdb.read_database(path, use_two_view_geometries=tvg)
    b = tdb.read_database(path, use_two_view_geometries=tvg)
    _assert_same_db(a, b)
    assert len(a.pairs) > 5


def test_writers_write_the_same_rows(tmp_path):
    pj, pt = str(tmp_path / "j.db"), str(tmp_path / "t.db")
    jdb.write_database(pj, **_contents(JCamera, jdb, 2))
    tdb.write_database(pt, **_contents(TCamera, tdb, 2))
    for table in ("cameras", "images", "keypoints", "matches",
                  "two_view_geometries"):
        rows = []
        for p in (pj, pt):
            con = sqlite3.connect(p)
            rows.append(con.execute(
                f"SELECT * FROM {table} ORDER BY 1").fetchall())
            con.close()
        assert rows[0] == rows[1], table


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_database_to_view_graph_fields_equal(tmp_path, seed):
    path = str(tmp_path / "database.db")
    tdb.write_database(path, **_contents(TCamera, tdb, seed))
    a = jdb.database_to_view_graph(jdb.read_database(path))
    b = tdb.database_to_view_graph(tdb.read_database(path))
    assert a._fields == b._fields
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if name == "cameras":
            for ca, cb in zip(x, y, strict=True):
                assert ca.model == cb.model
                np.testing.assert_array_equal(ca.params, cb.params)
        elif isinstance(x, list):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
        else:
            np.testing.assert_array_equal(x, y)
    assert not b.valid.all() and b.valid.any()


def test_pair_ids_match():
    for a, b in [(1, 2), (7, 3), (100, 100), (1, 2147483646)]:
        pid = tdb.pair_id_from_images(a, b)
        assert pid == jdb.pair_id_from_images(a, b)
        assert tdb.images_from_pair_id(pid) == jdb.images_from_pair_id(pid)
