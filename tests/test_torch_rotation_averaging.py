"""The mapper's compute stages on torch (``ops/l1.py``,
``pipeline/rotation_averaging.py``, ``pipeline/calibration.py`` and
``refine._expm_so3``): ``xmtpu_torch`` on the host against ``xmtpu``.

Tolerances: the L1 solutions within 1e-10, rotations within 1e-8,
residual angles within 1e-10 and the filter's masks exact; focal lengths
within 1e-9 relative; the SO(3) maps within 1e-12, with no NaN near angle
0 or pi."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu.ops import l1 as jl1
from xmtpu.pipeline import calibration as jcal
from xmtpu.pipeline import rotation_averaging as jra
from xmtpu.pipeline.refine import _expm_so3 as j_expm
from xmtpu.pipeline.synthetic import random_rotation
from xmtpu_torch.ops import l1 as tl1
from xmtpu_torch.pipeline import calibration as tcal
from xmtpu_torch.pipeline import rotation_averaging as tra
from xmtpu_torch.pipeline.refine import _expm_so3 as t_expm

CPU = "cpu"


def _l1_problem(seed, rows=120, cols=8, n_out=25):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(rows, cols))
    x = rng.normal(size=cols)
    b = A @ x
    out = rng.choice(rows, n_out, replace=False)
    b[out] += rng.normal(scale=30.0, size=n_out)
    return A, b, x


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("max_iters", [3, 1000])
def test_l1_solve_dense_matches(seed, max_iters):
    A, b, x_gt = _l1_problem(seed)
    want = np.asarray(jl1.l1_solve_dense(A, b, max_iters))
    got = tl1.l1_solve_dense(A, b, max_iters, device=CPU).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    if max_iters == 1000:
        assert np.abs(got - x_gt).max() < 1e-4


def test_make_l1_admm_on_tuples_matches():
    """Operators on a pair of row blocks (the rotation-averaging shape):
    x -> (x[j] - x[i], x[0]) and its adjoint."""
    rng = np.random.default_rng(3)
    N, E = 12, 40
    i, j = rng.integers(0, N, E), rng.integers(0, N, E)
    x_gt = rng.normal(size=(N, 3))
    r_e = x_gt[j] - x_gt[i] + rng.normal(scale=1e-3, size=(E, 3))
    r_e[:4] += 5.0
    r_f = x_gt[0]

    def j_ops():
        ij, jj = jnp.asarray(i), jnp.asarray(j)

        def A(x):
            return (x[jj] - x[ij], x[0])

        def At(y):
            ye, yf = y
            out = (jnp.zeros((N, 3)).at[jj].add(ye)
                   - jnp.zeros((N, 3)).at[ij].add(ye))
            return out.at[0].add(yf)
        return A, At

    def t_ops():
        it, jt = torch.as_tensor(i), torch.as_tensor(j)

        def A(x):
            return (x[jt] - x[it], x[0])

        def At(y):
            ye, yf = y
            out = (torch.zeros((N, 3), dtype=ye.dtype).index_add_(0, jt, ye)
                   - torch.zeros((N, 3), dtype=ye.dtype)
                   .index_add_(0, it, ye))
            out[0] += yf
            return out
        return A, At

    js = jl1.make_l1_admm(*j_ops(), 3 * (E + 1), 3 * N, cg_iters=20)
    ts = tl1.make_l1_admm(*t_ops(), 3 * (E + 1), 3 * N, cg_iters=20)
    for iters in (1, 7, 200):
        want = np.asarray(js((jnp.asarray(r_e), jnp.asarray(r_f)),
                             jnp.zeros((N, 3)), iters))
        got = ts((torch.as_tensor(r_e), torch.as_tensor(r_f)),
                 torch.zeros((N, 3), dtype=torch.float64), iters).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def _rotvecs():
    rng = np.random.default_rng(0)
    axes = rng.normal(size=(12, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.array([0.0, 1e-9, 1e-7, 2e-6, 1e-3, 0.5, 2.0, 3.0,
                       np.pi - 2e-3, np.pi - 1e-4, np.pi - 1e-8, np.pi])
    return axes * angles[:, None]


def test_expm_so3_matches():
    w = _rotvecs()
    want = np.asarray(j_expm(jnp.asarray(w)))
    got = t_expm(torch.as_tensor(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.isfinite(got).all()


def test_log_so3_edges_match():
    """Angles at and near 0 and pi: the same values, no NaN from the
    untaken branch."""
    w = _rotvecs()
    R = np.asarray(j_expm(jnp.asarray(w)))
    R = np.concatenate([R, np.eye(3)[None],
                        np.diag([1.0, -1.0, -1.0])[None]])   # angle pi
    want = np.asarray(jra._log_so3(jnp.asarray(R)))
    got = tra._log_so3(torch.as_tensor(R)).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def _ra_problem(N=20, extra=40, noise=0.01, n_out=0, seed=0):
    """The JAX package's rotation-averaging test problem, numpy only."""
    rng = np.random.default_rng(seed)
    R_gt = np.stack([random_rotation(rng) for _ in range(N)])
    R_gt[0] = np.eye(3)
    pairs = [(i, i + 1) for i in range(N - 1)]
    while len(pairs) < N - 1 + extra:
        i, j = rng.integers(0, N, 2)
        if i != j:
            pairs.append((min(i, j), max(i, j)))
    pairs = np.asarray(pairs)
    R_rel = np.einsum("eab,ecb->eac", R_gt[pairs[:, 1]], R_gt[pairs[:, 0]])
    dw = rng.normal(size=(len(pairs), 3)) * noise
    R_rel = t_expm(torch.as_tensor(dw)).numpy() @ R_rel
    out = rng.choice(len(pairs), size=n_out, replace=False)
    for e in out:
        R_rel[e] = random_rotation(rng)
    weights = rng.integers(30, 300, size=len(pairs)).astype(np.float64)
    return R_gt, pairs, R_rel, out, weights


@pytest.mark.parametrize("case", [
    dict(noise=0.0), dict(noise=0.02, seed=3),
    dict(N=40, extra=100, noise=0.01, n_out=30, seed=5)])
def test_rotation_averaging_matches(case):
    R_gt, pairs, R_rel, _, weights = _ra_problem(**case)
    want = jra.rotation_averaging(pairs, R_rel, len(R_gt), weights=weights)
    got = tra.rotation_averaging(pairs, R_rel, len(R_gt), weights=weights,
                                 device=CPU)
    np.testing.assert_allclose(got.rotations, want.rotations, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.residual_angles, want.residual_angles,
                               rtol=0, atol=1e-10)


def test_filter_pairs_masks_match():
    R_gt, pairs, R_rel, out, _ = _ra_problem(noise=0.005, n_out=5, seed=4)
    keep_j, _ = jra.filter_pairs(pairs, R_rel, len(R_gt), max_angle_deg=10.0)
    keep_t, res = tra.filter_pairs(pairs, R_rel, len(R_gt),
                                   max_angle_deg=10.0, device=CPU)
    np.testing.assert_array_equal(keep_t, keep_j)
    assert not keep_t[out].any()
    assert keep_t.sum() >= len(pairs) - len(out) - 2
    opts = tra.RotationEstimatorOptions(weight_type="HALF_NORM",
                                        max_num_l1_iterations=0)
    keep_j, rj = jra.filter_pairs(
        pairs, R_rel, len(R_gt),
        opts=jra.RotationEstimatorOptions(weight_type="HALF_NORM",
                                          max_num_l1_iterations=0))
    keep_t, rt = tra.filter_pairs(pairs, R_rel, len(R_gt), opts=opts,
                                  device=CPU)
    np.testing.assert_array_equal(keep_t, keep_j)
    np.testing.assert_allclose(rt.rotations, rj.rotations, rtol=0, atol=1e-8)


def _calibration_inputs(seed, n_cams=1, n_pairs=15):
    """General-position relative poses (``tests/test_colmap_db.py``'s
    focal test), cameras of focal 500 + 40 k."""
    rng = np.random.default_rng(seed)
    w, h = 640, 480
    f_true = 500.0 + 40.0 * np.arange(n_cams)
    F, c0, c1 = [], [], []
    for _ in range(n_pairs):
        a_, b_ = rng.integers(0, n_cams, 2)
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        R = np.asarray(j_expm(jnp.asarray(axis * (0.2 + 0.4 * rng.random()))))
        t = rng.normal(size=3)
        K0 = np.array([[f_true[a_], 0, w / 2], [0, f_true[a_], h / 2],
                       [0, 0, 1.0]])
        K1 = np.array([[f_true[b_], 0, w / 2], [0, f_true[b_], h / 2],
                       [0, 0, 1.0]])
        F.append(jcal.fundamental_from_pose(K0, K1, R, t / np.linalg.norm(t)))
        c0.append(a_)
        c1.append(b_)
    pp = np.tile([w / 2, h / 2], (n_cams, 1))
    return np.stack(F), np.array(c0), np.array(c1), pp, f_true


@pytest.mark.parametrize("n_cams,prior", [(1, None), (3, [False, True,
                                                         False])])
def test_calibrate_view_graph_matches(n_cams, prior):
    F, c0, c1, pp, f_true = _calibration_inputs(0, n_cams, 15 * n_cams)
    f0 = 0.85 * f_true
    want = jcal.calibrate_view_graph(F, c0, c1, pp, f0, prior_mask=prior)
    got = tcal.calibrate_view_graph(F, c0, c1, pp, f0, prior_mask=prior,
                                    device=CPU)
    np.testing.assert_allclose(got["focals"], want["focals"], rtol=1e-9)
    np.testing.assert_array_equal(got["refined"], want["refined"])
    np.testing.assert_array_equal(got["pair_valid"], want["pair_valid"])
    np.testing.assert_allclose(got["residuals"], want["residuals"], rtol=0,
                               atol=1e-9)
    # the free cameras near the truth (the prior one is held at 0.85 f)
    free = ~np.asarray(prior if prior is not None else [False] * n_cams)
    np.testing.assert_allclose(got["focals"][free], f_true[free], rtol=1e-4)
    np.testing.assert_array_equal(tcal.fetzer_coeffs(F, pp[c0], pp[c1]),
                                  jcal.fetzer_coeffs(F, pp[c0], pp[c1]))


def test_calibration_rejects_a_failed_factorization_as_the_reference():
    """Where the damped normal matrix is not positive definite the
    reference's Cholesky gives NaN and its step is rejected (``lm *= 10``);
    the port's ``cholesky_ex`` must take the same path: a focal of 0 makes
    every residual NaN-free but the Jacobian singular."""
    F, c0, c1, pp, _ = _calibration_inputs(1, 2, 12)
    f0 = np.array([0.0, 480.0])
    want = jcal.calibrate_view_graph(F, c0, c1, pp, f0)
    got = tcal.calibrate_view_graph(F, c0, c1, pp, f0, device=CPU)
    for k in ("focals", "refined", "pair_valid"):
        np.testing.assert_array_equal(np.isnan(got[k].astype(float)),
                                      np.isnan(want[k].astype(float)))
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9)


def test_fundamental_from_pose_matches():
    F, c0, c1, pp, _ = _calibration_inputs(2, 2, 4)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1.0]])
    R = np.asarray(j_expm(jnp.asarray([0.1, -0.2, 0.3])))
    np.testing.assert_allclose(
        tcal.fundamental_from_pose(K, K, R, [0.3, 0.1, 1.0]),
        jcal.fundamental_from_pose(K, K, R, [0.3, 0.1, 1.0]), rtol=0,
        atol=1e-15)


def test_calibration_on_the_loop_of_scene_d_matches():
    """Scene D's own relative poses turn about the vertical only, so every
    two optical axes meet and the focal is not observable from them: both
    packages land at the same wrong focal (634.1 instead of 600 on the
    24-frame scene), which is why ``chip_smoke.py`` calibrates on
    general-position poses (``scene_d_calibration_inputs``)."""
    import chip_smoke

    sc = chip_smoke.make_scene_d(n_frames=24, n_points=1000, seed=0)
    F = []
    for i, j in sc.pairs:
        R = sc.R[j] @ sc.R[i].T
        t = sc.t[j] - R @ sc.t[i]
        F.append(jcal.fundamental_from_pose(sc.K, sc.K, R,
                                            t / np.linalg.norm(t)))
    zero = np.zeros(len(F), dtype=np.int64)
    args = (np.stack(F), zero, zero, sc.K[None, :2, 2], [510.0])
    want = jcal.calibrate_view_graph(*args, prior_mask=[False])
    got = tcal.calibrate_view_graph(*args, prior_mask=[False], device=CPU)
    np.testing.assert_allclose(got["focals"], want["focals"], rtol=1e-9)
    assert abs(got["focals"][0] - 600.0) > 6.0
    F, c0, c1, pp, f0 = chip_smoke.scene_d_calibration_inputs(sc)
    want = jcal.calibrate_view_graph(F, c0, c1, pp, f0, prior_mask=[False])
    got = tcal.calibrate_view_graph(F, c0, c1, pp, f0, prior_mask=[False],
                                    device=CPU)
    np.testing.assert_allclose(got["focals"], want["focals"], rtol=1e-9)
    assert abs(got["focals"][0] - 600.0) <= 1e-6 * 600.0
