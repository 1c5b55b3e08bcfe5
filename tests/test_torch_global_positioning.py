"""Stage 5 (``pipeline/global_positioning.py``) and gravity refinement
(``pipeline/gravity.py``): ``xmtpu_torch`` on the host against ``xmtpu``,
on the seven cases of ``tests/test_global_positioning.py``.

The same numpy inputs go through both packages.  Positions and points
agree within 1e-8 of the scene's extent (the two scatters of each CG apply
add in another order: the reference scatters +v at dst then -v at src into
one array, the port subtracts two segment sums), scales within 1e-8 and
the constraint arrays exactly; the numpy gravity refiner gives the same
bits.  Each case also keeps its reference test's own assertion on the
port's result.

One case is ill-conditioned: the outlier scene of
``test_huber_downweights_outliers``, where the reference itself moves its
unknowns by 4e-4 (of 300) after one outer iteration, and by 6 (of 850)
after 128, when its directions are perturbed by 1e-15 relative.  There
the two packages' camera centres are held after the similarity alignment
to ground truth, within 1e-2 of each other (0.17 and 1.9 from ground
truth), with the reference's own assertion on the port's result.
"""

import numpy as np
import pytest

from xmtpu.pipeline import global_positioning as jgp
from xmtpu.pipeline import gravity as jgr
from xmtpu_torch.pipeline import global_positioning as tgp
from xmtpu_torch.pipeline import gravity as tgr

CPU = "cpu"


def _rotmat(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _align(est, gt):
    """similarity-align est to gt (the BATA gauge: translation + scale)."""
    est = est - est.mean(axis=0)
    gt0 = gt - gt.mean(axis=0)
    s = np.sum(est * gt0) / max(np.sum(est * est), 1e-12)
    return s * est, gt0


def _solve_both(*args, centers=None, **kw):
    """``global_positioning`` of both packages on the same inputs; the
    port's result, held against the reference's (given ground-truth
    ``centers``: the ill-conditioned hold, after the alignment to them)."""
    opts = kw.pop("opts")
    j = jgp.global_positioning(*args, opts=jgp.PositionerOptions(**opts),
                               **kw)
    t = tgp.global_positioning(*args, opts=tgp.PositionerOptions(**opts),
                               device=CPU, **kw)
    if centers is not None:
        np.testing.assert_allclose(_align(t["positions"], centers)[0],
                                   _align(j["positions"], centers)[0],
                                   rtol=0, atol=1e-2)
        return t
    u_j = np.concatenate([j["positions"], j["points"]])
    extent = max(np.abs(u_j).max(), 1.0)
    for k in ("positions", "points"):
        assert t[k].shape == j[k].shape
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-8 * extent,
                                   err_msg=k)
    np.testing.assert_allclose(t["scales"], j["scales"], rtol=1e-8, atol=0)
    np.testing.assert_allclose(t["residual_norms"], j["residual_norms"],
                               rtol=0, atol=1e-8)
    assert t["cost"] == pytest.approx(j["cost"], rel=1e-6, abs=1e-12)
    return t


def _point_scene(rng, N, M, p):
    centers = rng.normal(size=(N, 3))
    points = rng.uniform([-3, -3, 5], [3, 3, 10], size=(M, 3))
    cam, trk = np.nonzero(rng.random((N, M)) < p)
    d = points[trk] - centers[cam]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return centers, points, cam, trk, d


def _point_constraints(*args, **kw):
    a = jgp.point_constraints(*args, **kw)
    b = tgp.point_constraints(*args, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)
    return b


def test_only_points_recovers_centers():
    rng = np.random.default_rng(0)
    N, M = 12, 80
    centers = rng.normal(size=(N, 3))
    points = rng.uniform([-3, -3, 5], [3, 3, 10], size=(M, 3))
    cam, trk = np.nonzero(np.ones((N, M)) * (rng.random((N, M)) < 0.8))
    d = points[trk] - centers[cam]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ci, ti, dd, keep = _point_constraints(
        cam, trk, d, np.tile(np.eye(3), (N, 1, 1)), N,
        min_num_view_per_track=3)
    assert keep.all()
    out = _solve_both(ci, ti, dd, N, M, opts=dict(outer_iters=96, seed=3))
    est, gt = _align(out["positions"], centers)
    err = np.linalg.norm(est - gt, axis=1)
    scene = np.linalg.norm(gt, axis=1).mean()
    assert err.max() < 1e-3 * max(scene, 1.0), err.max()


def test_camera_constraints_direction_convention():
    rng = np.random.default_rng(1)
    N = 8
    centers = rng.normal(size=(N, 3)) * 2
    Rw = np.stack([_rotmat(rng.normal(size=3), rng.random())
                   for _ in range(N)])
    pi, pj = np.triu_indices(N, 1)
    t_rel = np.einsum("kab,kb->ka", Rw[pj].transpose(0, 2, 1),
                      centers[pi] - centers[pj])
    a = jgp.camera_constraints(pi, pj, Rw, t_rel)
    ci, cj, d = tgp.camera_constraints(pi, pj, Rw, t_rel)
    for x, y in zip(a, (ci, cj, d)):
        np.testing.assert_array_equal(y, x)
    diff = centers[cj] - centers[ci]
    assert np.linalg.norm(np.cross(d, diff), axis=1).max() < 1e-10
    out = _solve_both(ci, cj, d, N, 0, opts=dict(
        constraint_type="ONLY_CAMERAS", outer_iters=96, seed=5))
    est, gt = _align(out["positions"], centers)
    assert np.linalg.norm(est - gt, axis=1).max() < 1e-6


def test_huber_downweights_outliers():
    """The robust solve and the plain least-squares one (a huge Huber
    delta), each against the reference; the robust one must be clearly
    better, as in the reference's test."""
    rng = np.random.default_rng(2)
    N, M = 10, 60
    centers, points, cam, trk, d = _point_scene(rng, N, M, 0.6)
    n_bad = len(d) // 20
    bad = rng.choice(len(d), n_bad, replace=False)
    d[bad] = rng.normal(size=(n_bad, 3))
    d[bad] /= np.linalg.norm(d[bad], axis=1, keepdims=True)
    ci, ti, dd, _ = _point_constraints(cam, trk, d,
                                       np.tile(np.eye(3), (N, 1, 1)), N)
    err = {}
    for delta in (1e-1, 1e9):
        out = _solve_both(ci, ti, dd, N, M, centers=centers, opts=dict(
            outer_iters=128, seed=7, huber_delta=delta))
        est, gt = _align(out["positions"], centers)
        err[delta] = np.linalg.norm(est - gt, axis=1)
    assert np.median(err[1e-1]) < 0.05
    assert err[1e-1].max() < 0.6 * err[1e9].max()


def test_fixed_scales_and_frozen_positions_match():
    """The options the mapper's ONLY_CAMERAS branch and the CLI reach:
    scales pinned at 1 (held as the other cases), and points re-estimated
    with positions frozen at given values.  The latter is as
    ill-conditioned as the outlier scene: the reference moves its points by
    5e-3 (of 7.6) under a 1e-15 perturbation of its directions, so there
    the frozen positions must be equal (the gauge projection zeroes them in
    both) and the final costs agree within 1e-3."""
    rng = np.random.default_rng(8)
    N, M = 9, 40
    centers, points, cam, trk, d = _point_scene(rng, N, M, 0.7)
    ci, ti, dd, keep = _point_constraints(cam, trk, d,
                                          np.tile(np.eye(3), (N, 1, 1)), N)
    _solve_both(ci, ti, dd, N, int(keep.sum()),
                opts=dict(outer_iters=16, optimize_scales=False))
    kw = dict(init_positions=centers, weights=0.5 + rng.random(len(ci)),
              init_points=points + 0.1 * rng.normal(size=points.shape))
    j = jgp.global_positioning(ci, ti, dd, N, int(keep.sum()),
                               opts=jgp.PositionerOptions(
                                   outer_iters=16, optimize_positions=False),
                               **kw)
    t = tgp.global_positioning(ci, ti, dd, N, int(keep.sum()),
                               opts=tgp.PositionerOptions(
                                   outer_iters=16, optimize_positions=False),
                               device=CPU, **kw)
    np.testing.assert_array_equal(t["positions"], j["positions"])
    assert t["cost"] == pytest.approx(j["cost"], rel=1e-3)


def test_short_tracks_dropped():
    cam = np.array([0, 1, 2, 0, 1])
    trk = np.array([0, 0, 0, 1, 1])  # track 1 has 2 views < 3
    d = np.ones((5, 3))
    ci, ti, dd, keep = _point_constraints(
        cam, trk, d, np.tile(np.eye(3), (3, 1, 1)), 3)
    assert keep.tolist() == [True, False]
    assert len(ci) == 3
    assert (ti == 3).all()


def test_no_constraints_raise_in_both():
    for gp in (jgp, tgp):
        kw = {"device": CPU} if gp is tgp else {}
        with pytest.raises(ValueError, match="no constraints"):
            gp.global_positioning(np.zeros(0), np.zeros(0),
                                  np.zeros((0, 3)), 2, **kw)


# ---------------------------------------------------------------- gravity

def test_gravity_to_ralign_column():
    g = np.array([0.3, -0.8, 0.5])
    R = tgr.gravity_to_ralign(g)
    np.testing.assert_array_equal(R, jgr.gravity_to_ralign(g))
    assert np.allclose(R[:, 1], g / np.linalg.norm(g))
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-12)
    assert np.linalg.det(R) > 0


def _refine_both(*args, opts=None):
    j = jgr.refine_gravity(*args, opts=opts and jgr.GravityRefinerOptions(
        **opts))
    t = tgr.refine_gravity(*args, opts=opts and tgr.GravityRefinerOptions(
        **opts))
    for x, y in zip(j, t):
        np.testing.assert_array_equal(y, x)
    return t


def test_refine_gravity_fixes_corrupted_image():
    rng = np.random.default_rng(3)
    N = 10
    g_world = np.array([0.0, 1.0, 0.0])
    Rws = np.stack([_rotmat(rng.normal(size=3), rng.random())
                    for _ in range(N)])
    G = np.einsum("nab,b->na", Rws, g_world)
    pi, pj = np.triu_indices(N, 1)
    R_rel = Rws[pj] @ Rws[pi].transpose(0, 2, 1)
    G_noisy = G.copy()
    G_noisy[4] = _rotmat([1.0, 0.2, 0.1], 0.5) @ G[4]

    G_out, refined, prone = _refine_both(pi, pj, R_rel, G_noisy)
    assert prone[4] and refined[4]
    assert not prone[np.arange(N) != 4].any()
    err = np.degrees(np.arccos(np.clip(G_out[4] @ G[4], -1, 1)))
    assert err < 0.1, err


def test_refine_gravity_rejects_when_neighbors_disagree():
    rng = np.random.default_rng(4)
    N = 9
    Rws = np.stack([_rotmat(rng.normal(size=3), rng.random())
                    for _ in range(N)])
    G = np.einsum("nab,b->na", Rws, np.array([0.0, 1.0, 0.0]))
    pi, pj = np.triu_indices(N, 1)
    R_rel = np.stack([_rotmat(rng.normal(size=3), rng.uniform(0.5, 3.0))
                      for _ in range(len(pi))])
    G_out, refined, prone = _refine_both(pi, pj, R_rel, G,
                                         opts=dict(min_num_neighbors=5))
    assert not refined.any()
