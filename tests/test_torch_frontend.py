"""Front-end adapters of the mapper (``pipeline/frontend.py``, the
``establish_tracks`` runtime): ``xmtpu_torch`` against ``xmtpu``.

Track ids must be equal on the native union-find and on the scipy path
(each package's own, ties between tracks of one size included), and the
view graph, lifting and tempdata parsing equal (numpy copies: exact, floats
within 1e-12)."""

import numpy as np
import pytest

import xmtpu.runtime as jrt
import xmtpu_torch.runtime as trt
from xmtpu.pipeline import frontend as jfe
from xmtpu.pipeline.global_mapper import export_tempdata as j_export
from xmtpu.pipeline.global_mapper import global_mapper_solve
from xmtpu_torch.pipeline import frontend as tfe
from xmtpu_torch.pipeline.global_mapper import export_tempdata as t_export


@pytest.fixture(params=["native", "scipy"])
def route(request, monkeypatch):
    """Both packages on their native library, or both on scipy."""
    if request.param == "native":
        assert jrt.have_native() and trt.have_native()
    else:
        monkeypatch.setattr(jrt, "_load", lambda: None)
        monkeypatch.setattr(trt, "_load", lambda: None)
        assert not (jrt.have_native() or trt.have_native())
    return request.param


def _matches(seed, n_nodes=3000, n_matches=2500):
    """Random matches over nodes: many tracks of equal size (ties)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_nodes, n_matches),
            rng.integers(0, n_nodes, n_matches), n_nodes)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_establish_tracks_match(route, seed):
    a, b, n = _matches(seed)
    nj, tj = jrt.establish_tracks(a, b, n)
    nt, tt = trt.establish_tracks(a, b, n)
    assert nt == nj
    np.testing.assert_array_equal(tt, tj)
    sizes = np.bincount(tt)
    assert (np.diff(sizes) <= 0).all()
    assert (np.diff(sizes) == 0).sum() > 100       # ties abound
    np.testing.assert_array_equal(
        trt.connected_component_labels(a, b, n)[1],
        jrt.connected_component_labels(a, b, n)[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_tracks_from_feature_matches_match(route, seed):
    rng = np.random.default_rng(seed)
    im1 = rng.integers(0, 12, 4000)
    im2 = (im1 + rng.integers(1, 11, 4000)) % 12
    f1 = rng.integers(0, 300, 4000)
    f2 = rng.integers(0, 300, 4000)
    kj, tj = jfe.tracks_from_feature_matches(im1, f1, im2, f2)
    kt, tt = tfe.tracks_from_feature_matches(im1, f1, im2, f2)
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(tt, tj)


def _export_matches(seed, N=9, M=120, E=700):
    rng = np.random.default_rng(seed)
    m = np.zeros((E, 4))
    m[:, 0] = rng.integers(1, N + 1, E)
    m[:, 3] = rng.integers(1, M + 1, E)
    m[:, 1] = rng.uniform(0, 640, E)
    m[:, 2] = rng.uniform(0, 480, E)
    m[:10, 0], m[:10, 3] = N, M            # the largest ids present
    return m, N, M


@pytest.mark.parametrize("seed", [0, 1])
def test_build_view_graph_and_lifting_match(seed):
    m, N, M = _export_matches(seed)
    vj = jfe.build_view_graph(m)
    vt = tfe.build_view_graph(m)
    for x, y in zip(vj, vt):
        np.testing.assert_array_equal(y, x)
    rng = np.random.default_rng(seed)
    depth = {i: rng.uniform(0.5, 4.0, (480, 640)) * (rng.random((480, 640))
                                                      > 0.2)
             for i in range(N)}
    conf = {i: rng.uniform(0.1, 1.0, (480, 640)) for i in range(N)}
    K = np.array([[500.0, 0, 320], [0, 510.0, 240], [0, 0, 1]])
    for kw in ({}, dict(border_margin=12, depth_clip_pct=90.0)):
        lj = jfe.lift_dataset(vj, lambda i: (depth[i], conf[i]),
                              lambda i: K, **kw)
        lt = tfe.lift_dataset(vt, lambda i: (depth[i], conf[i]),
                              lambda i: K, **kw)
        np.testing.assert_array_equal(lt[0], lj[0])
        np.testing.assert_allclose(lt[1], lj[1], rtol=0, atol=1e-12)
        np.testing.assert_allclose(lt[2], lj[2], rtol=0, atol=1e-12)
    for q in ([1, 0, 0, 0], [0.7, 0.1, -0.3, 0.2]):
        np.testing.assert_allclose(tfe.quat2rot(*q), jfe.quat2rot(*q),
                                   rtol=0, atol=1e-15)


def _assert_same_export(a, b):
    np.testing.assert_array_equal(a.matches, b.matches)
    np.testing.assert_array_equal(a.filenames, b.filenames)
    assert (a.N, a.M) == (b.N, b.M)
    assert sorted(a.relposes) == sorted(b.relposes)
    for k in a.relposes:
        np.testing.assert_allclose(b.relposes[k][0], a.relposes[k][0],
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(b.relposes[k][1], a.relposes[k][1],
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("writer", ["xmtpu", "xmtpu_torch"])
def test_parse_tempdata_of_either_package(tmp_path, writer):
    from tests.test_colmap_db import _ring_scene, _write_scene_db
    from xmtpu.pipeline.colmap_db import database_to_view_graph, read_database

    rng = np.random.default_rng(7)
    R, t, pts, keypoints, K = _ring_scene(rng, n_cams=8, n_pts=50)
    db = tmp_path / "database.db"
    _write_scene_db(db, R, t, keypoints, 500.0, 640, 480)
    vg = database_to_view_graph(read_database(str(db)))
    res = global_mapper_solve(vg)
    out = str(tmp_path / "tempdata")
    (j_export if writer == "xmtpu" else t_export)(res, vg, out)
    exp_j = jfe.parse_glomap_tempdata(out)
    exp_t = tfe.parse_glomap_tempdata(out)
    _assert_same_export(exp_j, exp_t)
    assert exp_t.N == 8 and len(exp_t.relposes) == 28
