"""Camera models, view-graph processors and graph manipulation of the
mapper (``pipeline/undistort.py``, ``viewgraph.py``, ``manipulation.py``):
``xmtpu_torch`` against ``xmtpu`` on the same seeded numpy inputs.

The port's modules are numpy copies, so integers and masks must be equal
and floats within 1e-12.
"""

import numpy as np
import pytest

from xmtpu.pipeline import global_mapper as jgm
from xmtpu.pipeline import manipulation as jvm
from xmtpu.pipeline import undistort as jud
from xmtpu.pipeline import viewgraph as jvg
from xmtpu_torch.pipeline import global_mapper as tgm
from xmtpu_torch.pipeline import manipulation as tvm
from xmtpu_torch.pipeline import undistort as tud
from xmtpu_torch.pipeline import viewgraph as tvg

ATOL = 1e-12

PARAMS = {
    "SIMPLE_PINHOLE": [500.0, 320.0, 240.0],
    "PINHOLE": [500.0, 510.0, 320.0, 240.0],
    "SIMPLE_RADIAL": [500.0, 320.0, 240.0, -0.08],
    "RADIAL": [500.0, 320.0, 240.0, -0.08, 0.02],
    "OPENCV": [500.0, 510.0, 320.0, 240.0, -0.08, 0.02, 1e-3, -5e-4],
    "FULL_OPENCV": [500.0, 510.0, 320.0, 240.0, -0.08, 0.02, 1e-3, -5e-4,
                    0.005, -0.01, 0.002, -0.001],
    "OPENCV_FISHEYE": [400.0, 405.0, 320.0, 240.0, 0.05, -0.01, 0.002,
                       -0.0005],
}


def test_every_camera_model_has_params():
    assert set(PARAMS) == set(jud._FOCAL_LAYOUT) == set(tud._FOCAL_LAYOUT)
    assert jud._FOCAL_LAYOUT == tud._FOCAL_LAYOUT


@pytest.mark.parametrize("model", sorted(jud._FOCAL_LAYOUT))
def test_undistort_matches(model):
    jcam = jud.Camera(model, PARAMS[model], 640, 480)
    tcam = tud.Camera(model, PARAMS[model], 640, 480)
    np.testing.assert_array_equal(jcam.K, tcam.K)
    assert jcam.focal == tcam.focal
    rng = np.random.default_rng(0)
    xy = rng.uniform(-0.4, 0.4, size=(300, 2))
    xyd = jud.distort(jcam, xy)
    np.testing.assert_allclose(tud.distort(tcam, xy), xyd, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tud.undistort(tcam, xyd),
                               jud.undistort(jcam, xyd), rtol=0, atol=ATOL)
    uv = rng.uniform([0, 0], [640, 480], size=(300, 2))
    np.testing.assert_allclose(tud.cam_from_img(tcam, uv),
                               jud.cam_from_img(jcam, uv), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tud.undistorted_bearings(tcam, uv),
                               jud.undistorted_bearings(jcam, uv), rtol=0,
                               atol=ATOL)
    kp = {3: uv[:100], 7: uv[100:]}
    got = tud.undistort_images({3: tcam, 7: tcam}, kp)
    want = jud.undistort_images({3: jcam, 7: jcam}, kp)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL)


def _rotmat(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _pair(seed, n=200, n_out=30):
    rng = np.random.default_rng(seed)
    R = _rotmat(rng.normal(size=3), rng.uniform(0.1, 0.6))
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    X = rng.uniform([-2, -2, 3], [2, 2, 8], size=(n, 3))
    b1 = X / np.linalg.norm(X, axis=1, keepdims=True)
    X2 = X @ R.T + t
    b2 = X2 / np.linalg.norm(X2, axis=1, keepdims=True)
    b2 = b2 + rng.normal(scale=1e-4, size=b2.shape)
    junk = rng.normal(size=(n_out, 3))
    junk[:, 2] = np.abs(junk[:, 2]) + 0.5
    b2[-n_out:] = junk
    b2 /= np.linalg.norm(b2, axis=1, keepdims=True)
    return R, t, b1, b2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_viewgraph_processors_match(seed):
    R, t, b1, b2 = _pair(seed)
    E = jvg.essential_from_motion(R, t)
    np.testing.assert_allclose(tvg.essential_from_motion(R, t), E, rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tvg.sampson_error(E, b1, b2),
                               jvg.sampson_error(E, b1, b2), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(tvg.check_cheirality(R, t, b1, b2),
                                  jvg.check_cheirality(R, t, b1, b2))
    thr = jvg.InlierThresholds(max_epipolar_error_E=2.0)
    jm, js = jvg.pair_inliers(R, t, b1, b2, 500.0, 520.0, thr)
    tm, ts = tvg.pair_inliers(R, t, b1, b2, 500.0, 520.0,
                              tvg.InlierThresholds(max_epipolar_error_E=2.0))
    np.testing.assert_array_equal(tm, jm)
    assert abs(ts - js) <= ATOL * max(1.0, abs(js))
    assert 0 < jm.sum() < len(jm)
    rng = np.random.default_rng(seed)
    inl = rng.integers(0, 100, size=50)
    mat = inl + rng.integers(0, 200, size=50)
    np.testing.assert_array_equal(tvg.filter_pairs_by_inliers(inl, mat),
                                  jvg.filter_pairs_by_inliers(inl, mat))


def _graph(seed, n=30, n_pairs=70):
    rng = np.random.default_rng(seed)
    pairs = set()
    while len(pairs) < n_pairs:
        i, j = rng.integers(0, n, 2)
        if i != j:
            pairs.add((min(i, j), max(i, j)))
    pairs = np.array(sorted(pairs))
    valid = rng.random(len(pairs)) > 0.15
    weights = rng.integers(1, 200, size=len(pairs)).astype(np.float64)
    return pairs, valid, weights, n


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_components_and_spanning_tree_match(seed):
    pairs, valid, weights, n = _graph(seed)
    for jr, tr in zip(jvm.keep_largest_connected_component(pairs, valid, n),
                      tvm.keep_largest_connected_component(pairs, valid, n)):
        np.testing.assert_array_equal(tr, jr)
    for jr, tr in zip(
            jvm.mark_connected_components(pairs, valid, n, min_num_img=2),
            tvm.mark_connected_components(pairs, valid, n, min_num_img=2)):
        np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(
        tvm.maximum_spanning_tree(pairs, valid, weights, n),
        jvm.maximum_spanning_tree(pairs, valid, weights, n))
    for jr, tr in zip(
            jvm.establish_strong_clusters(pairs, valid, weights, n,
                                          min_thres=60.0, min_num_images=2),
            tvm.establish_strong_clusters(pairs, valid, weights, n,
                                          min_thres=60.0, min_num_images=2)):
        np.testing.assert_array_equal(tr, jr)


@pytest.mark.parametrize("seed", [0, 1])
def test_update_image_pairs_config_matches(seed):
    pairs, valid, _, n = _graph(seed)
    rng = np.random.default_rng(seed)
    config = rng.choice([jvm.CALIBRATED, jvm.UNCALIBRATED, jvm.PLANAR],
                        size=len(pairs), p=[0.6, 0.3, 0.1])
    cam_of = rng.integers(0, 5, size=n)
    prior = rng.random(5) > 0.3
    j_cfg, j_prom = jvm.update_image_pairs_config(pairs, valid, config,
                                                  cam_of, prior)
    t_cfg, t_prom = tvm.update_image_pairs_config(pairs, valid, config,
                                                  cam_of, prior)
    np.testing.assert_array_equal(t_cfg, j_cfg)
    np.testing.assert_array_equal(t_prom, j_prom)


def test_decompose_relpose_matches():
    P = 8
    pairs = np.array([(i, i + 1) for i in range(P)])
    config = np.full(P, jvm.UNCALIBRATED)
    config[2] = jvm.PLANAR
    valid = np.ones(P, dtype=bool)
    valid[5] = False
    E, b1s, b2s = [], [], []
    for p in range(P):
        R, t, b1, b2 = _pair(10 + p, n=60, n_out=5)
        E.append(jvg.essential_from_motion(R, t))
        b1s.append(b1)
        b2s.append(b2)
    E = np.stack(E)
    cam_of = np.zeros(P + 1, dtype=np.int64)
    cam_of[4] = 1
    prior = np.array([True, False])
    want = jvm.decompose_relpose(pairs, valid, config, E, b1s, b2s, cam_of,
                                 prior)
    got = tvm.decompose_relpose(pairs, valid, config, E, b1s, b2s, cam_of,
                                prior)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[2], want[2])
    for p in range(P):
        jr = jvm.pose_from_essential(E[p], b1s[p], b2s[p])
        tr = tvm.pose_from_essential(E[p], b1s[p], b2s[p])
        np.testing.assert_allclose(tr[0], jr[0], rtol=0, atol=ATOL)
        np.testing.assert_allclose(tr[1], jr[1], rtol=0, atol=ATOL)
        assert tr[2] == jr[2]


def test_covisibility_and_pruning_match():
    rng = np.random.default_rng(6)
    edges = np.array([(i, tr) for tr in range(60)
                      for i in rng.choice(8, size=rng.integers(2, 6),
                                          replace=False)])
    for jr, tr in zip(jvm.covisibility_pairs(edges, 8),
                      tvm.covisibility_pairs(edges, 8)):
        np.testing.assert_array_equal(tr, jr)
    for jr, tr in zip(jvm.prune_weakly_connected_images(edges, 8),
                      tvm.prune_weakly_connected_images(edges, 8)):
        np.testing.assert_array_equal(tr, jr)
    for jr, tr in zip(jgm.prune_from_observations(edges, 8),
                      tgm.prune_from_observations(edges, 8)):
        np.testing.assert_array_equal(tr, jr)


@pytest.mark.parametrize("min_per_view,max_tracks", [(0, 10**7), (2, 10**7),
                                                     (3, 12), (1, 5)])
def test_select_tracks_greedy_matches(min_per_view, max_tracks):
    rng = np.random.default_rng(7)
    obs_track = np.repeat(np.arange(80), rng.integers(2, 7, size=80))
    obs_img = rng.integers(0, 10, size=len(obs_track))
    j = jgm._select_tracks_greedy(obs_img, obs_track, 80, 10, min_per_view,
                                  max_tracks)
    t = tgm._select_tracks_greedy(obs_img, obs_track, 80, 10, min_per_view,
                                  max_tracks)
    assert t.any() and not t.all()
    np.testing.assert_array_equal(t, j)
