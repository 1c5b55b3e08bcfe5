"""Dense dual certificate: ``xmtpu_torch.solver.certificate`` against
``xmtpu.solver.certificate`` at the same points.

``Z`` and the dual are the same f64 algebra (1e-10 relative).  Lanczos runs
get a shared start vector ``v0``; the inverse-Lanczos refinement of the
'auto' path draws its own start in each package, so refined eigenvalues
agree to the refinement's accuracy (1e-8) rather than to rounding.  The
verdict, the dual and the gap must agree in every method.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu.assembly.creatematrix import create_matrix_arrays
from xmtpu.pipeline.synthetic import make_scene
from xmtpu.solver import certificate as jc
from xmtpu.solver.staircase import solve_arrays
from xmtpu_torch.solver import certificate as tc


@pytest.fixture(scope="module")
def scene():
    sc = make_scene(n_cameras=12, n_points=48, obs_per_camera=14,
                    noise=0.05, seed=2)
    C, _ = create_matrix_arrays(sc.weights, sc.edges, sc.landmarks)
    C = np.array(C)
    res = solve_arrays(C, max_rank=3, tol=1e-9, rank3_only=True,
                       verbose=False)
    sR = np.asarray(res.R) * np.repeat(np.asarray(res.s_ex), 3)[:, None]
    return C, sR, float(res.primal)


def _identity_point(C):
    n = C.shape[0] // 3
    sR = np.tile(np.eye(3), (n, 1))
    return sR, float(np.vdot(sR, C @ sR))


def _v0(dim, seed=9):
    return np.random.default_rng(seed).normal(size=dim)


def test_z_and_dual_parity(scene):
    C, sR, _ = scene
    Zj, dj = jc._z_and_dual(jnp.asarray(C), jnp.asarray(sR), 0.3)
    Zt, dt = tc._z_and_dual(torch.tensor(C), torch.tensor(sR), 0.3)
    Zj = np.asarray(Zj)
    np.testing.assert_allclose(Zt.numpy(), Zj, rtol=1e-10,
                               atol=1e-10 * np.abs(Zj).max())
    np.testing.assert_allclose(float(dt), float(dj), rtol=1e-10)


def test_small_spd_solve_and_patterns():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(7, 5, 5))
    G = A @ np.swapaxes(A, 1, 2) + np.eye(5)
    g = rng.normal(size=(7, 5))
    np.testing.assert_allclose(
        tc._solve_spd_small(torch.tensor(G), torch.tensor(g)).numpy(),
        np.linalg.solve(G, g[..., None])[..., 0], rtol=1e-10)
    np.testing.assert_array_equal(tc._camera0_patterns().numpy(),
                                  np.asarray(jc._camera0_patterns()))
    np.testing.assert_array_equal(tc._camera_patterns().numpy(),
                                  np.asarray(jc._camera_patterns()))
    assert [tc._min_eig_bound(n) for n in (10, 2000, 2001)] == \
        [jc._min_eig_bound(n) for n in (10, 2000, 2001)]


@pytest.mark.parametrize("method", ["auto", "eigh", "lanczos"])
@pytest.mark.parametrize("at_optimum", [True, False])
def test_certify_parity(scene, method, at_optimum):
    C, sR, primal = scene
    if not at_optimum:
        sR, primal = _identity_point(C)
    v0 = _v0(C.shape[0])
    ref = jc.certify(jnp.asarray(C), jnp.asarray(sR), 0.0, primal,
                     method=method, v0=jnp.asarray(v0))
    got = tc.certify(C, sR, 0.0, primal, method=method, v0=torch.tensor(v0),
                     device="cpu")
    assert got.certified == bool(ref.certified) == at_optimum
    np.testing.assert_allclose(got.dual, float(ref.dual), rtol=1e-10,
                               atol=1e-10 * abs(primal))
    np.testing.assert_allclose(got.lam_min, float(ref.lam_min), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(got.gap, float(ref.gap), rtol=1e-6,
                               atol=1e-6 * abs(primal))
    if not at_optimum:
        # the escape direction: same eigenvector up to sign
        v, vr = got.v.numpy(), np.asarray(ref.v)
        np.testing.assert_allclose(np.sign(v @ vr) * v, vr, atol=1e-6)


def test_build_z_dual_psd_parity(scene):
    C, sR, _ = scene
    ref = jc._build_z_dual_psd(jnp.asarray(C), jnp.asarray(sR), 0.0,
                               jc._min_eig_bound(12))
    got = tc._build_z_dual_psd(torch.tensor(C), torch.tensor(sR), 0.0,
                               tc._min_eig_bound(12))
    assert got[2] == bool(ref[2]) is True
    np.testing.assert_allclose(got[1], float(ref[1]), rtol=1e-10)
    np.testing.assert_allclose(got[3], float(ref[3]), atol=1e-8)
    np.testing.assert_allclose(got[4], float(ref[4]), atol=1e-8)


def test_failed_probe_flags_without_raising():
    """An indefinite Z: the Cholesky probe reports failure (the reference's
    NaN factor) instead of raising."""
    C = -np.eye(9)
    sR = np.tile(np.eye(3), (3, 1))
    got = tc._build_z_dual_psd(torch.tensor(C), torch.tensor(sR), 0.0, 1e-4)
    ref = jc._build_z_dual_psd(jnp.asarray(C), jnp.asarray(sR), 0.0, 1e-4)
    assert got[2] is False and bool(ref[2]) is False


def test_deflated_min_eig_parity_above_1500():
    """The branch that dense problems with 3n > 1500 take (scene B's), run
    directly at dim 1503 with a shared Lanczos start."""
    dim, o = 1503, 3
    rng = np.random.default_rng(4)
    sR = rng.normal(size=(dim, o))
    # Z with an o-dimensional near-kernel along sR, as at a converged point
    B = rng.normal(size=(dim, 40))
    P = np.eye(dim) - sR @ np.linalg.solve(sR.T @ sR, sR.T)
    # and one separated negative eigenvalue outside it (an escape direction)
    p = P[:, 0] / np.linalg.norm(P[:, 0])
    Z = P @ (B @ B.T / 40 + 0.05 * np.eye(dim)) @ P - 0.1 * np.outer(p, p)
    v0 = rng.normal(size=dim)
    ref = jc._deflated_min_eig(lambda X: jnp.asarray(Z) @ X, jnp.asarray(sR),
                               v0=jnp.asarray(v0))
    Zt = torch.tensor(Z)
    got = tc._deflated_min_eig(lambda X: Zt @ X, torch.tensor(sR),
                               v0=torch.tensor(v0))
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-9, atol=1e-9)
    v, vr = got[2].numpy(), np.asarray(ref[2])
    np.testing.assert_allclose(np.sign(v @ vr) * v, vr, atol=1e-6)
