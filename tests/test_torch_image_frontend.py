"""The image front end of the port (``xmtpu_torch.pipeline.features``, on
OpenCV and numpy) against the JAX package's: the same rendered views give
the same features, matches, two-view geometry, tracks and lifted
observations, and pixels go to certified poses through the port alone."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from xmtpu.pipeline import features as jf
from xmtpu.pipeline.synthetic_images import make_texture as j_texture
from xmtpu.pipeline.synthetic_images import render_plane_views as j_render
from xmtpu_torch.pipeline import features as tf
from xmtpu_torch.pipeline import synthetic_images as tsi


@pytest.fixture(scope="module")
def views():
    """Four 240-pixel views of the textured plane, GT depth."""
    images, depths, R_gt, t_gt, K = tsi.render_plane_views(
        n_views=4, size=240, focal=180.0)
    return images, depths, R_gt, t_gt, K


def test_rendered_views_match(views):
    images, depths, R_gt, t_gt, K = views
    ref = j_render(n_views=4, size=240, focal=180.0)
    for a, b in zip(ref[0], images):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ref[1], depths):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(R_gt, ref[2], rtol=0, atol=1e-15)
    np.testing.assert_array_equal(t_gt, ref[3])
    np.testing.assert_array_equal(tsi.make_texture(64, 3),
                                  j_texture(64, 3))


def test_features_matches_and_geometry(views):
    images, _, _, _, K = views
    fa = [jf.extract_features(im, 800) for im in images[:2]]
    fb = [tf.extract_features(im, 800) for im in images[:2]]
    for a, b in zip(fa, fb):
        np.testing.assert_array_equal(a.keypoints, b.keypoints)
        np.testing.assert_array_equal(a.descriptors, b.descriptors)
    m = tf.match_pair(*fb)
    np.testing.assert_array_equal(m, jf.match_pair(*fa))
    assert len(m) > 50
    pa, pb = fb[0].keypoints[m[:, 0]], fb[1].keypoints[m[:, 1]]
    for x, y in zip(tf.two_view_geometry(pa, pb, K),
                    jf.two_view_geometry(pa, pb, K)):
        np.testing.assert_array_equal(x, y)
    assert tf.two_view_geometry(pa[:7], pb[:7], K) == (None, None, None)
    empty = tf.ImageFeatures(np.zeros((0, 2)), np.zeros((0, 128), np.float32))
    assert tf.match_pair(empty, fb[1]).shape == (0, 2)


@pytest.mark.parametrize("path", ["opencv", "8-point"])
def test_two_view_fundamental(views, path, monkeypatch):
    """OpenCV's RANSAC where cv2 imports, else the normalized 8-point fit,
    in both packages."""
    images = views[0]
    f = [tf.extract_features(im, 800) for im in images[1:3]]
    m = tf.match_pair(*f)
    pa, pb = f[0].keypoints[m[:, 0]], f[1].keypoints[m[:, 1]]
    if path == "8-point":
        monkeypatch.setattr(jf, "_HAS_CV2", False)
        monkeypatch.setattr(tf, "_HAS_CV2", False)
    F, inl = tf.two_view_fundamental(pa, pb)
    F_ref, inl_ref = jf.two_view_fundamental(pa, pb)
    np.testing.assert_array_equal(inl, inl_ref)
    np.testing.assert_allclose(F, F_ref, rtol=0,
                               atol=1e-12 * np.abs(F_ref).max())
    assert tf.two_view_fundamental(pa[:7], pb[:7]) == (None, None)


def test_tracks_and_calibration(views):
    images, _, _, _, K = views
    feats = [tf.extract_features(im, 800) for im in images]
    matches, relposes = tf.match_exhaustive(feats, K)
    ref_matches, ref_relposes = jf.match_exhaustive(feats, K)
    assert [(i, j) for i, j, _ in matches] == [(i, j) for i, j, _ in
                                               ref_matches]
    for (_, _, a), (_, _, b) in zip(matches, ref_matches):
        np.testing.assert_array_equal(a, b)
    assert relposes.keys() == ref_relposes.keys()
    for k in relposes:
        for x, y in zip(relposes[k], ref_relposes[k]):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(tf.build_tracks(matches, len(images)),
                    jf.build_tracks(ref_matches, len(images))):
        np.testing.assert_array_equal(x, y)
    raw, _ = tf.match_exhaustive(feats, None, verify=False)
    f, valid = tf.calibrate_from_matches(feats, raw, K[:2, 2], 150.0,
                                         device="cpu")
    f_ref, valid_ref = jf.calibrate_from_matches(feats, raw, K[:2, 2], 150.0)
    np.testing.assert_array_equal(valid, valid_ref)
    assert abs(f - f_ref) <= 1e-9 * f_ref


@pytest.mark.parametrize("how", ["gt depth", "gt depth, focal refined",
                                 "depth model"])
def test_run_frontend_matches(views, how):
    """Edges, weights, landmarks and relative poses of both packages'
    ``run_frontend``; the depth either as maps or through each package's
    ``NoisyDepthModel`` with the same seed."""
    from xmtpu.pipeline.depth import NoisyDepthModel as JNoisy
    from xmtpu_torch.pipeline.depth import NoisyDepthModel as TNoisy

    images, depths, _, _, K = views

    def depth_for_frame(i):
        return depths[i], np.ones_like(depths[i])

    kw = dict(max_features=800, border_margin=3,
              refine_focal=how.endswith("refined"))
    if how == "depth model":
        got = tf.run_frontend(images, K, depth_model=TNoisy(
            images, depths, rel_sigma=0.01, seed=4), device="cpu", **kw)
        want = jf.run_frontend(images, K, depth_model=JNoisy(
            images, depths, rel_sigma=0.01, seed=4), **kw)
    else:
        got = tf.run_frontend(images, K, depth_for_frame, device="cpu", **kw)
        want = jf.run_frontend(images, K, depth_for_frame, **kw)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    # a refined focal differs in its last digits (the two LMs sum in other
    # orders), and the essential-matrix poses follow it: rotations 4.9e-10
    # and translation directions 2.2e-8 apart (measured); else 1e-12
    tol = 1e-6 if kw["refine_focal"] else 1e-12
    assert got[3].keys() == want[3].keys()
    for k in got[3]:
        for x, y in zip(got[3][k], want[3][k]):
            np.testing.assert_allclose(x, y, rtol=0, atol=tol)
    with pytest.raises(ValueError, match="depth_for_frame or depth_model"):
        tf.run_frontend(images, K, device="cpu")


def test_pixels_to_certified_poses(views):
    """The pixels-to-poses chain of ``tests/test_images_end_to_end.py`` in
    the port on the CPU (SIFT, matches, tracks, GT-depth lifting, XM^2):
    certified poses within that test's bounds of the rendering's ground
    truth, and within 1e-6 of the JAX package's on the same observations."""
    from xmtpu.pipeline.xm2 import xm2_solve as jax_xm2
    from xmtpu_torch.pipeline import metrics
    from xmtpu_torch.pipeline.xm2 import xm2_solve

    images, depths, R_gt, t_gt, K = views

    def depth_for_frame(i):
        return depths[i], np.ones_like(depths[i])

    edges, weights, landmarks, relposes = tf.run_frontend(
        images, K, depth_for_frame, max_features=1500, border_margin=3,
        device="cpu")
    assert len(edges) > 300 and len(relposes) >= len(images) - 1
    N, M = int(edges[:, 0].max()), int(edges[:, 1].max())
    assert N == len(images)
    args = (edges, weights, landmarks, np.zeros((len(edges), 3)), N, M)
    kw = dict(max_rank=4, tol=1e-6, verbose=False, percentile=95.0)
    out = xm2_solve(*args, device="cpu", **kw)
    ref = jax_xm2(*args, **kw)
    for a, b in ((out.R_real, ref.R_real), (out.t_est, ref.t_est)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    live = out.indices_all > -1
    order = out.indices_all[live]
    R_gt_w2c = np.concatenate([R.T for R in R_gt[live]], axis=1)
    t_w2c = -np.einsum("nba,nb->na", R_gt[live], t_gt[live]).T
    N2 = out.s_real.shape[0]
    Rb = out.R_real.reshape(3, N2, 3).transpose(1, 0, 2)[order]
    m = metrics.evaluate(Rb.transpose(1, 0, 2).reshape(3, -1),
                         out.t_est[:, order], R_gt_w2c, t_w2c, robust=False)
    assert m["ATE_R_deg"] < 1.0
    assert m["ATE_T"] < 0.05
