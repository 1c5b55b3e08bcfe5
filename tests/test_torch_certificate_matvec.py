"""The implicit (matvec-only) certificate: ``xmtpu_torch`` against ``xmtpu``
on the implicit scenes of ``tests/test_certificate.py``, host only.

Both packages must reach the same verdict through the same deciding branch
(``info["path"]``).  The CG shift probe draws its start vectors from the
same numpy seeds in both; the deflated Lanczos prelude and the probe's
fallback deflation direction draw theirs from each package's own generator,
so iteration counts are compared within the port (chunk sizes) and the
decisions across packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu.assembly.creatematrix import create_matrix_arrays
from xmtpu.ops.schurq import SchurQ as JQ
from xmtpu.pipeline.synthetic import make_scene
from xmtpu.solver import certificate as jc
from xmtpu.solver.staircase import solve_arrays as j_solve
from xmtpu_torch.ops import manifold as tmf
from xmtpu_torch.ops.schurq import SchurQ as TQ
from xmtpu_torch.solver import certificate as tc
from xmtpu_torch.solver.staircase import solve_arrays as t_solve

CPU = "cpu"


def _both(scene):
    args = (scene.weights, scene.edges, scene.landmarks)
    return JQ.build(*args), TQ.build(*args, device=CPU)


def _gt_factor(scene):
    return (scene.s_gt[:, None, None]
            * np.transpose(scene.R_gt, (0, 2, 1))).reshape(-1, 3)


def _primal(Qt, sR):
    s = torch.tensor(sR)
    return float(torch.sum(s * Qt.apply(s)))


def _random_frames(n, seed):
    rng = np.random.default_rng(seed)
    return np.linalg.qr(rng.standard_normal((n, 3, 3)))[0].reshape(-1, 3)


def _check_same(cj, ct):
    assert bool(cj.certified) == ct.certified
    assert cj.info["path"] == ct.info["path"]
    return ct


@pytest.fixture(scope="module")
def scene64():
    scene = make_scene(n_cameras=64, n_points=400, obs_per_camera=25,
                       noise=0.0, seed=9)
    return (scene,) + _both(scene)


def test_verdict_matches_dense_and_reference(scene64):
    """Same point, same verdict from the implicit and dense certificates of
    both packages; a random (indefinite-Z) point fails in all four."""
    scene, Qj, Qt = scene64
    C, _ = create_matrix_arrays(scene.weights, scene.edges, scene.landmarks)
    C = np.asarray(C)
    for sR, want in ((_gt_factor(scene), True),
                     (_random_frames(64, 4), False)):
        primal = _primal(Qt, sR)
        ct = _check_same(jc.certify(Qj, jnp.asarray(sR), 0.0, primal),
                         tc.certify(Qt, sR, 0.0, primal, device=CPU))
        assert ct.certified == want
        assert tc.certify(C, sR, 0.0, primal, device=CPU).certified == want
        assert ct.v.shape == (3 * 64,) and np.isfinite(ct.gap)


def test_refutes_saddle_at_n1600():
    scene = make_scene(n_cameras=1600, n_points=6400, obs_per_camera=12,
                       noise=0.0, seed=5)
    Qj, Qt = _both(scene)
    sR = _random_frames(1600, 3)
    primal = _primal(Qt, sR)
    ct = _check_same(jc.certify(Qj, jnp.asarray(sR), 0.0, primal),
                     tc.certify(Qt, sR, 0.0, primal, device=CPU))
    assert not ct.certified and ct.lam_min < -1e-3


@pytest.fixture(scope="module")
def scene24():
    scene = make_scene(n_cameras=24, n_points=72, obs_per_camera=10,
                       noise=1e-3, seed=3)
    Qj, Qt = _both(scene)
    res = t_solve(Qt, max_rank=4, tol=1e-8, lam=0.0, verbose=False,
                  device=CPU)
    return Qj, Qt, res.R.reshape(-1, res.R.shape[-1])


def test_probe_chunked_continuation(scene24):
    """Same verdict and count whatever the chunk; the same verdict as the
    reference's probe; a random point is refuted with a sound witness."""
    Qj, Qt, R = scene24
    sR = torch.tensor(R)
    big = tc._implicit_psd_probe(Qt, sR, 0.0, 1e-3, chunk=512)
    small = tc._implicit_psd_probe(Qt, sR, 0.0, 1e-3, chunk=3)
    ref = jc._implicit_psd_probe(Qj, jnp.asarray(R), 0.0,
                                 jnp.asarray(1e-3, jnp.float64), chunk=512)
    assert big.accept == small.accept == ref.accept
    assert big.iters == small.iters
    if big.accept:
        assert big.converged

    n = Qt.n_cameras
    R_bad = tmf.mgs_rows(torch.tensor(np.random.default_rng(0).standard_normal(
        (n, 3, 3))))
    sR_bad = tmf.flatten(R_bad)
    pr = tc._implicit_psd_probe(Qt, sR_bad, 0.0, 1e-3, chunk=7)
    pr_ref = jc._implicit_psd_probe(Qj, jnp.asarray(sR_bad.numpy()), 0.0,
                                    jnp.asarray(1e-3, jnp.float64), chunk=7)
    assert pr.refuted and not pr.accept and pr_ref.refuted
    zmul, _ = tc._implicit_z_parts(Qt, sR_bad, 0.0)
    w = pr.wdir
    assert float(w @ (zmul(w[:, None])[:, 0] + 1e-3 * w)) <= 0.0


def test_probe_truncated_budget_not_accepted():
    """Z + shift I indefinite by a hair: a 4-iteration budget can neither
    converge nor witness — inconclusive in both packages, never accepted;
    and a converged pass under ``min_explore`` is not accepted either."""
    scene = make_scene(n_cameras=24, n_points=72, obs_per_camera=10,
                       noise=1e-3, seed=5)
    Qj, Qt = _both(scene)
    n = Qt.n_cameras
    R_bad = tmf.mgs_rows(torch.tensor(np.random.default_rng(1).standard_normal(
        (n, 3, 3))))
    sR_bad = tmf.flatten(R_bad)
    zmul, _ = tc._implicit_z_parts(Qt, sR_bad, 0.0)
    Zmat = zmul(torch.eye(3 * n, dtype=torch.float64)).numpy()
    lam_min = float(np.linalg.eigvalsh(0.5 * (Zmat + Zmat.T))[0])
    assert lam_min < 0.0
    shift = -lam_min - 1e-6
    pr = tc._implicit_psd_probe(Qt, sR_bad, 0.0, shift, max_iters=4, chunk=4)
    ref = jc._implicit_psd_probe(Qj, jnp.asarray(sR_bad.numpy()), 0.0,
                                 jnp.asarray(shift, jnp.float64),
                                 max_iters=4, chunk=4)
    assert not pr.accept and not ref.accept
    assert not pr.converged or pr.refuted

    scene0 = make_scene(n_cameras=24, n_points=72, obs_per_camera=10,
                        noise=0.0, seed=5)
    Q0 = TQ.build(scene0.weights, scene0.edges, scene0.landmarks, device=CPU)
    sR = tmf.flatten(tmf.scale_blocks(
        torch.tensor(np.broadcast_to(np.eye(3), (24, 3, 3)).copy()),
        torch.tensor(scene0.s_gt)))
    pr = tc._implicit_psd_probe(Q0, sR, 0.0, 10.0, max_iters=4, chunk=4,
                                min_explore=32)
    ref = jc._implicit_psd_probe(Qj.__class__.build(
        scene0.weights, scene0.edges, scene0.landmarks), jnp.asarray(
        sR.numpy()), 0.0, jnp.asarray(10.0, jnp.float64), max_iters=4,
        chunk=4, min_explore=32)
    # 4 directions < min_explore: whatever the pass found, no acceptance
    assert not pr.accept and not ref.accept
    assert (pr.refuted, pr.converged) == (ref.refuted, ref.converged)


@pytest.fixture(scope="module")
def scene8():
    scene = make_scene(n_cameras=8, n_points=40, obs_per_camera=20,
                       noise=1e-3, seed=77)
    return _both(scene)


def test_certify_fast_two_float(scene8):
    """``certify(fast=Q.two_float())``: the same decision and branch as the
    exact flow and as the reference's fast flow, at a certified point and at
    a clearly suboptimal one."""
    Qj, Qt = scene8
    res = j_solve(Qj, max_rank=4, tol=1e-9, lam=0.0, verbose=False)
    assert res.certified
    sR = res.R * np.repeat(res.s_ex, 3)[:, None]
    exact = tc.certify(Qt, sR, 0.0, res.primal, device=CPU)
    fast = _check_same(
        jc.certify(Qj, jnp.asarray(sR), 0.0, res.primal,
                   fast=Qj.two_float(pallas=False)),
        tc.certify(Qt, sR, 0.0, res.primal, fast=Qt.two_float(pallas=False),
                   device=CPU))
    assert exact.certified and fast.certified
    sR_bad = np.random.default_rng(9).normal(size=(3 * Qt.n_cameras, 3))
    bad = _check_same(
        jc.certify(Qj, jnp.asarray(sR_bad), 0.0, 1.0,
                   fast=Qj.two_float(pallas=False)),
        tc.certify(Qt, sR_bad, 0.0, 1.0, fast=Qt.two_float(pallas=True),
                   device=CPU))
    assert not bad.certified


def test_fast_auto_takes_the_exact_flow(scene8):
    """``fast="auto"`` derives no fast operator (the reference's CPU
    branch): the same result as ``fast=None``."""
    Qj, Qt = scene8
    sR = _random_frames(8, 2)
    a = tc.certify(Qt, sR, 0.0, 1.0, fast="auto", device=CPU)
    b = tc.certify(Qt, sR, 0.0, 1.0, device=CPU)
    assert a.certified == b.certified and a.info == b.info
    assert a.gap == b.gap and a.lam_min == b.lam_min
