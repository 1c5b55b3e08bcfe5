"""Stage 7 (``pipeline/triangulation.py``) with the numpy copies it and
stage 6 lean on (``pipeline/track_filter.py``, ``pipeline/normalize.py``):
``xmtpu_torch`` on the host against ``xmtpu``.

The same numpy inputs go through both packages.  Triangulated points agree
within 1e-9 of their scale wherever a track is valid (the per-track 4x4
sums add in the reference's edge order through one stable permutation; the
eigenvector's sign is free, and ``h / h[3]`` removes it), validity and
keep masks are equal, and the numpy filters and the normalisation give the
same bits.  Each case also keeps its reference test's own assertion on the
port's result.
"""

import numpy as np
import pytest

from tests.test_bundle_adjustment import _pixels, _rig
from xmtpu.pipeline import normalize as jnm
from xmtpu.pipeline import track_filter as jtf
from xmtpu.pipeline import triangulation as jtr
from xmtpu_torch.pipeline import normalize as tnm
from xmtpu_torch.pipeline import track_filter as ttf
from xmtpu_torch.pipeline import triangulation as ttr

CPU = "cpu"
CAM = np.array([[500.0, 500.0, 320.0, 240.0, 0, 0, 0, 0]])


def _triangulate_both(*args, **kw):
    xj, vj = jtr.triangulate_tracks(*args, **kw)
    xt, vt = ttr.triangulate_tracks(*args, device=CPU, **kw)
    np.testing.assert_array_equal(vt, vj)
    scale = max(np.abs(xj[vj]).max(initial=0.0), 1.0)
    np.testing.assert_allclose(xt[vj], xj[vj], rtol=0, atol=1e-9 * scale)
    return xt, vt


@pytest.mark.parametrize("shuffle", [False, True])
def test_triangulate_tracks_exact(shuffle):
    """Observations by image as the mapper passes them, and shuffled (the
    sums by track gather through the permutation)."""
    rng = np.random.default_rng(4)
    R, t, pts, i, j, x_cam = _rig(rng)
    xy = x_cam[:, :2] / x_cam[:, 2:3]
    p = rng.permutation(len(i)) if shuffle else np.arange(len(i))
    xyz, valid = _triangulate_both(i[p], j[p], xy[p], R, t, len(pts))
    assert valid.all()
    np.testing.assert_allclose(xyz, pts, atol=1e-9)
    _, valid1 = _triangulate_both(i[:1], j[:1], xy[:1], R, t, len(pts))
    assert not valid1[j[0]]


def test_triangulate_tracks_weights():
    """IRLS weights, some zero: a zero-weight observation is no support."""
    rng = np.random.default_rng(14)
    R, t, pts, i, j, x_cam = _rig(rng, n_pts=20)
    xy = x_cam[:, :2] / x_cam[:, 2:3] + rng.normal(scale=1e-3,
                                                   size=(len(i), 2))
    w = rng.random(len(i))
    w[j == 3] = 0.0
    w[np.flatnonzero(j == 5)[1:]] = 0.0
    _, valid = _triangulate_both(i, j, xy, R, t, len(pts), weights=w)
    assert not valid[3] and not valid[5] and valid.sum() == len(pts) - 2


def test_retriangulate_rejects_outliers():
    rng = np.random.default_rng(5)
    R, t, pts, i, j, x_cam = _rig(rng)
    uv = _pixels(x_cam, CAM[0]) + rng.normal(scale=0.5, size=(len(i), 2))
    out = rng.choice(len(uv), 20, replace=False)
    uv[out] += rng.normal(scale=200.0, size=(20, 2))
    args = (i, uv, j, R, t, CAM, np.zeros(len(R), int))
    rj = jtr.retriangulate(*args, jtr.TriangulatorOptions())
    res = ttr.retriangulate(*args, ttr.TriangulatorOptions(), device=CPU)
    np.testing.assert_array_equal(res.valid, rj.valid)
    np.testing.assert_array_equal(res.keep_obs, rj.keep_obs)
    np.testing.assert_allclose(res.xyz[rj.valid], rj.xyz[rj.valid], rtol=0,
                               atol=1e-8)
    assert res.keep_obs[out].sum() == 0
    inl = np.ones(len(uv), bool)
    inl[out] = False
    assert res.keep_obs[inl].mean() > 0.8
    good = res.valid
    assert good.sum() > 0.8 * len(pts)
    assert np.abs(res.xyz[good] - pts[good]).max() < 0.05


def test_retriangulate_empty():
    for tr, kw in ((jtr, {}), (ttr, {"device": CPU})):
        res = tr.retriangulate(np.zeros(0, int), np.zeros((0, 2)),
                               np.zeros(0, int), np.eye(3)[None],
                               np.zeros((1, 3)), CAM, [0], **kw)
        assert res.xyz.shape == (0, 3) and not res.keep_obs.size


# ------------------------------------------------------- track filters

def _filter_scene(rng):
    R, t, pts, i, j, x_cam = _rig(rng, n_cams=6, n_pts=30)
    edges = np.stack([i, j], axis=1)
    xy = x_cam[:, :2] / x_cam[:, 2:3]
    xy = xy + rng.normal(scale=5e-3, size=xy.shape)
    rays = np.concatenate([xy, np.ones((len(xy), 1))], axis=1)
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    xyz = pts + rng.normal(scale=0.02, size=pts.shape)
    xyz[3] = -t[0] @ R[0]            # track 3 at camera 0's centre
    return R, t, xyz, edges, rays, xy


@pytest.mark.parametrize("thr", [2e-3, 5e-3, 1e-2])
def test_filter_tracks_by_reprojection_matches(thr):
    R, t, xyz, edges, rays, _ = _filter_scene(np.random.default_rng(15))
    keep = ttf.filter_tracks_by_reprojection(edges, rays, R, t, xyz, thr)
    np.testing.assert_array_equal(
        keep, jtf.filter_tracks_by_reprojection(edges, rays, R, t, xyz,
                                                thr))
    assert 0 < keep.sum() < len(keep)


def test_filter_tracks_by_reprojection_in_pixels_matches():
    from xmtpu.pipeline.undistort import Camera as JCamera
    from xmtpu_torch.pipeline.undistort import Camera as TCamera

    R, t, xyz, edges, _, xy = _filter_scene(np.random.default_rng(16))
    uv = 500.0 * xy * (1 + 0.05 * (xy ** 2).sum(1))[:, None] + [320, 240]
    params = [500.0, 320.0, 240.0, 0.05]
    out = [mod.filter_tracks_by_reprojection(
        edges, uv, R, t, xyz, 2.0, cameras=[Cam(model="SIMPLE_RADIAL",
                                                params=params, width=640,
                                                height=480)],
        camera_of_frame=np.zeros(len(R), int), in_normalized_image=False)
        for mod, Cam in ((jtf, JCamera), (ttf, TCamera))]
    np.testing.assert_array_equal(out[1], out[0])


@pytest.mark.parametrize("prior", [None, "mixed"])
def test_filter_tracks_by_angle_matches(prior):
    R, t, xyz, edges, rays, _ = _filter_scene(np.random.default_rng(17))
    has_prior = None if prior is None else np.arange(len(R)) % 2 == 0
    keep = ttf.filter_tracks_by_angle(edges, rays, R, t, xyz, 0.5,
                                      has_prior)
    np.testing.assert_array_equal(
        keep, jtf.filter_tracks_by_angle(edges, rays, R, t, xyz, 0.5,
                                         has_prior))
    assert 0 < keep.sum() < len(keep)


@pytest.mark.parametrize("deg", [1.0, 20.0])
def test_filter_track_triangulation_angle_matches(deg):
    R, t, xyz, edges, _, _ = _filter_scene(np.random.default_rng(18))
    edges = edges[(edges[:, 1] != 7) | (edges[:, 0] == 2)]  # a 1-view track
    a = jtf.filter_track_triangulation_angle(edges, R, t, xyz, deg)
    b = ttf.filter_track_triangulation_angle(edges, R, t, xyz, deg)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)
    assert not b[1][7]
    assert ttf.EPS == jtf.EPS


# ------------------------------------------------------- normalisation

@pytest.mark.parametrize("kw", [dict(), dict(fixed_scale=True),
                                dict(registered="half"), dict(n=3)])
def test_normalize_reconstruction_matches(kw):
    rng = np.random.default_rng(19)
    kw = dict(kw)
    n = kw.pop("n", 12)
    R, t, pts, _, _, _ = _rig(rng, n_cams=max(n, 3), n_pts=25)
    R, t = R[:n], t[:n] + rng.normal(size=(n, 3))
    if kw.get("registered") == "half":
        kw["registered"] = np.arange(n) % 2 == 0
    Rj, tj, pj, fj = jnm.normalize_reconstruction(R, t, pts, **kw)
    Rt, tt, pt, ft = tnm.normalize_reconstruction(R, t, pts, **kw)
    for a, b in ((Rj, Rt), (tj, tt), (pj, pt), (fj.rotation, ft.rotation),
                 (fj.translation, ft.translation)):
        np.testing.assert_array_equal(b, a)
    assert ft.scale == fj.scale
    np.testing.assert_array_equal(ft.apply(pts), fj.apply(pts))
    with pytest.raises(ValueError, match="no registered"):
        tnm.normalize_reconstruction(R, t, registered=np.zeros(n, bool))
