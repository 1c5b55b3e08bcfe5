"""Stage 6 (``pipeline/bundle_adjustment.py``): ``xmtpu_torch`` on the host
against ``xmtpu``, on the cases of ``tests/test_bundle_adjustment.py``.

The same numpy inputs go through both packages.  Tolerances:

* the per-edge Jacobians of ``torch.func.vmap(jacfwd)`` within 1e-12 of
  ``jax.vmap(jacfwd)`` (relative to their largest entry);
* one LM step (linearize, Schur PCG, update) within 1e-10: the segment
  sums by image and track add in the reference's edge order, the sums by
  camera add per-image partial sums (another order), and the 100-step PCG
  carries the rounding;
* whole solves: equal iteration counts; poses, points and intrinsics
  within 1e-8 of their scale; costs within 1e-8 relative (1e-20 absolute
  at a cost that reaches 1e-22); ``run_bundle_adjustment``'s keep masks
  equal.

Each case also keeps its reference test's own assertion on the port's
result.  Two cases go past the reference's tests: observations that are not
sorted by image (the port sorts them, and must keep the caller's first
image as the gauge), and two cameras (the sums by camera).
"""

import numpy as np
import pytest
import torch

from tests.test_bundle_adjustment import _pixels, _rig
from xmtpu.pipeline import bundle_adjustment as jba
from xmtpu.pipeline.undistort import Camera as JCamera
from xmtpu_torch.ops.segsum import Segments
from xmtpu_torch.pipeline import bundle_adjustment as tba
from xmtpu_torch.pipeline.refine import _expm_so3
from xmtpu_torch.pipeline.undistort import Camera as TCamera

CPU = "cpu"
CAM = np.array([[500.0, 500.0, 320.0, 240.0, 0, 0, 0, 0]])


def _perturb_rot(R, rng, scale):
    dw = rng.normal(scale=scale, size=(len(R), 3))
    return (_expm_so3(torch.as_tensor(dw)) @ torch.as_tensor(R)).numpy()


def _ba_both(*args, fixed_image=None, **opts):
    j = jba.bundle_adjustment(*args, jba.BundleAdjusterOptions(**opts),
                              fixed_image=fixed_image)
    t = tba.bundle_adjustment(*args, tba.BundleAdjusterOptions(**opts),
                              fixed_image=fixed_image, device=CPU)
    assert t.iterations == j.iterations
    assert t.success == j.success
    for k in ("R", "t", "xyz", "cam_params"):
        a, b = getattr(j, k), getattr(t, k)
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-8 * max(np.abs(a).max(), 1.0),
                                   err_msg=k)
    assert t.cost_initial == pytest.approx(j.cost_initial, rel=1e-12)
    assert t.cost_final == pytest.approx(j.cost_final, rel=1e-8, abs=1e-20)
    return t


def _edge_inputs(rng, E, distorted=True):
    w = rng.normal(scale=0.3, size=(E, 3))
    R = (_expm_so3(torch.as_tensor(w))).numpy()
    t = rng.normal(size=(E, 3)) + [0.0, 0.0, 6.0]
    X = rng.normal(size=(E, 3))
    cam = np.tile([500.0, 510.0, 320.0, 240.0, 0.0, 0.0, 0.0, 0.0], (E, 1))
    if distorted:
        cam[:, 4:] = rng.normal(scale=[0.05, 0.01, 1e-3, 1e-3], size=(E, 4))
    obs = rng.uniform([0, 0], [640, 480], size=(E, 2))
    return R, t, X, cam, obs


@pytest.mark.parametrize("distorted", [False, True])
def test_edge_jacobian_matches(distorted):
    rng = np.random.default_rng(10)
    args = (np.zeros((64, 15)),) + _edge_inputs(rng, 64, distorted)
    Jj = np.asarray(jba._edge_jac_batch(*args))
    Jt = tba._edge_jac_batch(*(torch.as_tensor(a) for a in args)).numpy()
    assert Jt.shape == Jj.shape == (64, 2, 15)
    np.testing.assert_allclose(Jt, Jj, rtol=0, atol=1e-12 * np.abs(Jj).max())
    rj = np.asarray(jba._edge_residual_batch(*args))
    rt = tba._edge_residual_batch(*(torch.as_tensor(a) for a in args))
    np.testing.assert_allclose(rt.numpy(), rj, rtol=0, atol=1e-12 * 640)


def test_spd_inv_nan_where_cholesky_fails():
    H = np.stack([np.diag([2.0, 3.0, 4.0]), -np.eye(3)])
    got = tba._spd_inv(torch.as_tensor(H)).numpy()
    np.testing.assert_allclose(got[0], np.diag([0.5, 1 / 3, 0.25]))
    assert np.isnan(got[1]).all()
    assert np.isnan(np.asarray(jba._spd_inv(H))[1]).all()


@pytest.mark.parametrize("n_cams", [1, 2])
def test_one_step_matches(n_cams):
    """One linearize + Schur-PCG + update step of both packages from the
    same state, two cameras exercising the sums by camera."""
    rng = np.random.default_rng(11)
    R, t, pts, i, j, x_cam = _rig(rng, n_cams=6, n_pts=30)
    cams = np.tile(CAM, (n_cams, 1))
    cams[:, 4] = 0.01
    cam_of = np.arange(len(R)) % n_cams
    uv = _pixels(x_cam, CAM[0]) + rng.normal(scale=0.5, size=(len(i), 2))
    Rp = _perturb_rot(R, rng, 0.01)
    xp = pts + rng.normal(scale=0.02, size=pts.shape)
    N, M, C, E = len(R), len(pts), n_cams, len(i)
    masks = (np.r_[0.0, np.ones(N - 1)], np.ones(C), 1.0)
    step_j = jba._make_step_fn(E, N, M, C, 100)
    out_j = step_j(Rp, t, xp, cams, uv, i, cam_of[i], j, masks, 1.0, 1.0,
                   1.0, 1e-3)
    sums = tba._EdgeSums(Segments(i, N, CPU), Segments(j, M, CPU),
                         Segments(cam_of, C, CPU))
    step_t = tba._make_step_fn(100, sums)

    def T(a):
        return torch.as_tensor(a)

    out_t = step_t(T(Rp), T(t), T(xp), T(cams), T(uv), T(i), T(cam_of[i]),
                   T(j), (T(masks[0]), T(masks[1]), 1.0), 1.0, 1.0, 1.0,
                   1e-3)
    for a, b in zip(out_j[0], out_t[0]):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-10 * np.abs(a).max())
    for a, b in zip(out_j[1:], out_t[1:]):
        assert float(b) == pytest.approx(float(a), rel=1e-10)


def test_ba_recovers_perturbed_scene():
    rng = np.random.default_rng(0)
    R, t, pts, i, j, x_cam = _rig(rng)
    uv = _pixels(x_cam, CAM[0])
    Rp = _perturb_rot(R, rng, 0.02)
    tp = t + rng.normal(scale=0.05, size=t.shape)
    xp = pts + rng.normal(scale=0.05, size=pts.shape)
    res = _ba_both(i, uv, j, Rp, tp, xp, CAM, np.zeros(len(R), int),
                   optimize_intrinsics=False, max_iterations=60)
    assert res.success
    assert res.cost_final < 1e-10 * res.cost_initial
    np.testing.assert_allclose(res.R[i[0]], Rp[i[0]], atol=1e-12)
    np.testing.assert_allclose(res.t[i[0]], tp[i[0]], atol=1e-12)


def test_ba_unsorted_observations_keep_the_callers_gauge():
    """Observations in a shuffled order: the port sorts them by image and
    must still fix the first image of the caller's order."""
    rng = np.random.default_rng(12)
    R, t, pts, i, j, x_cam = _rig(rng)
    uv = _pixels(x_cam, CAM[0])
    p = rng.permutation(len(i))
    k = np.flatnonzero(i[p] != i.min())[0]
    p[[0, k]] = p[[k, 0]]
    assert i[p][0] != i.min()
    Rp = _perturb_rot(R, rng, 0.02)
    tp = t + rng.normal(scale=0.05, size=t.shape)
    xp = pts + rng.normal(scale=0.05, size=pts.shape)
    res = _ba_both(i[p], uv[p], j[p], Rp, tp, xp, CAM,
                   np.zeros(len(R), int), optimize_intrinsics=False,
                   max_iterations=60)
    g = i[p][0]
    np.testing.assert_array_equal(res.R[g], Rp[g])
    np.testing.assert_array_equal(res.t[g], tp[g])
    assert res.cost_final < 1e-10 * res.cost_initial


def test_ba_huber_downweights_outliers():
    rng = np.random.default_rng(1)
    R, t, pts, i, j, x_cam = _rig(rng)
    uv = _pixels(x_cam, CAM[0])
    out = rng.choice(len(uv), 15, replace=False)
    uv_noisy = uv.copy()
    uv_noisy[out] += rng.normal(scale=300.0, size=(15, 2))
    xp = pts + rng.normal(scale=0.03, size=pts.shape)
    res = _ba_both(i, uv_noisy, j, R, t, xp, CAM, np.zeros(len(R), int),
                   optimize_rotations=False, optimize_translation=False,
                   optimize_intrinsics=False, max_iterations=80)
    x_c = np.einsum("eab,eb->ea", R[i], res.xyz[j]) + t[i]
    uv_hat = _pixels(x_c, CAM[0])
    inl = np.ones(len(uv), bool)
    inl[out] = False
    assert np.median(np.linalg.norm(uv_hat[inl] - uv[inl], axis=1)) < 0.1


@pytest.mark.parametrize("n_cams", [1, 2])
def test_ba_intrinsics_recovery(n_cams):
    """One camera as in the reference's test, and the images split over
    two cameras with their own distortion (the sums by camera)."""
    rng = np.random.default_rng(2)
    R, t, pts, i, j, x_cam = _rig(rng, n_cams=10, n_pts=60)
    cam_gt = np.array([[500.0, 500.0, 320.0, 240.0, 0.05, -0.01, 0, 0],
                       [480.0, 480.0, 320.0, 240.0, -0.03, 0.0, 0, 0]])
    cam_of = np.arange(len(R)) % n_cams
    uv = np.zeros((len(i), 2))
    for c in range(n_cams):
        e = cam_of[i] == c
        uv[e] = _pixels(x_cam[e], cam_gt[c], k=cam_gt[c, 4:6])
    cam0 = cam_gt[:n_cams].copy()
    cam0[:, :2] += 20.0
    cam0[:, 4:] = 0.0
    res = _ba_both(i, uv, j, R, t, pts.copy(), cam0, cam_of,
                   max_iterations=100)
    assert res.cost_final < 1e-6
    for c in range(n_cams):
        e = cam_of[i] == c
        x_c = (np.einsum("eab,eb->ea", res.R[i[e]], res.xyz[j[e]])
               + res.t[i[e]])
        uv_hat = _pixels(x_c, res.cam_params[c], k=res.cam_params[c, 4:6])
        assert np.abs(uv_hat - uv[e]).max() < 1e-3


def test_run_bundle_adjustment_staged():
    rng = np.random.default_rng(3)
    R, t, pts, i, j, x_cam = _rig(rng)
    uv = _pixels(x_cam, CAM[0]) + rng.normal(scale=0.2, size=(len(i), 2))
    Rp = _perturb_rot(R, rng, 0.01)
    tp = t + rng.normal(scale=0.02, size=t.shape)
    xp = pts + rng.normal(scale=0.02, size=pts.shape)
    args = (i, uv, j, Rp, tp, xp, CAM, np.zeros(len(R), int))
    out_j = jba.run_bundle_adjustment(
        *args, opts=jba.BundleAdjusterOptions(optimize_intrinsics=False,
                                              max_iterations=40))
    out_t = tba.run_bundle_adjustment(
        *args, opts=tba.BundleAdjusterOptions(optimize_intrinsics=False,
                                              max_iterations=40),
        device=CPU)
    np.testing.assert_array_equal(out_t[0], out_j[0])
    for a, b in zip(out_j[1:], out_t[1:]):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-8 * max(np.abs(a).max(), 1.0))
    alive, R2, t2, x2, c2 = out_t
    assert alive.sum() > 0.8 * len(alive)
    x_c = np.einsum("eab,eb->ea", R2[i[alive]], x2[j[alive]]) + t2[i[alive]]
    uv_hat = _pixels(x_c, c2[0])
    assert np.median(np.linalg.norm(uv_hat - uv[alive], axis=1)) < 1.0


def test_undistorted_rays_match():
    rng = np.random.default_rng(13)
    cams = np.array([[500.0, 510.0, 320.0, 240.0, 0.1, -0.05, 1e-3, -2e-3],
                     [480.0, 480.0, 300.0, 250.0, 0.0, 0.0, 0.0, 0.0]])
    xy = rng.uniform([0, 0], [640, 480], size=(50, 2))
    obs_cam = rng.integers(0, 2, size=50)
    np.testing.assert_array_equal(tba._undistorted_rays(xy, cams, obs_cam),
                                  jba._undistorted_rays(xy, cams, obs_cam))


def test_generic_params_models():
    for Camera, mod in ((JCamera, jba), (TCamera, tba)):
        cam = Camera(model="OPENCV", params=[500.0, 510.0, 320.0, 240.0,
                                             0.1, -0.05, 1e-3, -2e-3],
                     width=640, height=480)
        np.testing.assert_allclose(
            mod.generic_params(cam),
            [500.0, 510.0, 320.0, 240.0, 0.1, -0.05, 1e-3, -2e-3])
        fisheye = Camera(model="OPENCV_FISHEYE",
                         params=[500.0, 500.0, 320.0, 240.0, 0.1, 0, 0, 0],
                         width=640, height=480)
        with pytest.raises(ValueError):
            mod.generic_params(fisheye)
    for model, params in (("SIMPLE_PINHOLE", [500.0, 320.0, 240.0]),
                          ("SIMPLE_RADIAL", [500.0, 320.0, 240.0, 0.1]),
                          ("RADIAL", [500.0, 320.0, 240.0, 0.1, -0.02])):
        np.testing.assert_array_equal(
            tba.generic_params(TCamera(model=model, params=params,
                                       width=640, height=480)),
            jba.generic_params(JCamera(model=model, params=params,
                                       width=640, height=480)))
