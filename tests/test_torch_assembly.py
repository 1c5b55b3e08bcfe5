"""Synthetic scenes and dense Q assembly: ``xmtpu_torch`` against ``xmtpu``.

``make_scene`` is a numpy copy that must make the same draws and return
identical arrays.  ``create_matrix_arrays`` runs the same f64 algebra in
another summation order (``index_add_`` for ``segment_sum``), so C and Abar
agree to 1e-10 relative to their largest entry; the mixed (f32 middle)
assembly agrees to 1e-4 of the largest entry, the f32 build's own error
being ~1e-6 relative.
"""

import os

import numpy as np
import pytest
import torch

from xmtpu.assembly import creatematrix as jcm
from xmtpu.io.bin_format import load_matrix_from_bin
from xmtpu.pipeline import synthetic as jsyn
from xmtpu_torch.assembly import creatematrix as tcm
from xmtpu_torch.pipeline import synthetic as tsyn

SCENES = [dict(n_cameras=8, n_points=60, obs_per_camera=40, seed=0),
          dict(n_cameras=30, n_points=120, obs_per_camera=4, noise=0.1,
               seed=3),
          dict(n_cameras=40, n_points=90, obs_per_camera=2, noise=0.05,
               seed=7)]


@pytest.mark.parametrize("params", SCENES)
def test_make_scene_identical(params):
    a, b = jsyn.make_scene(**params), tsyn.make_scene(**params)
    assert a._fields == b._fields
    for f in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(b, f)),
                                      np.asarray(getattr(a, f)), err_msg=f)


def test_rotation_helpers_identical():
    ra = jsyn.random_rotation(np.random.default_rng(5))
    rb = tsyn.random_rotation(np.random.default_rng(5))
    np.testing.assert_array_equal(rb, ra)
    sc = tsyn.make_scene(n_cameras=6, n_points=30, seed=1)
    noisy = sc.R_gt + 0.01 * np.random.default_rng(2).normal(size=sc.R_gt.shape)
    for gauge in ("right", "left"):
        np.testing.assert_array_equal(
            tsyn.rotation_errors(noisy, sc.R_gt, gauge),
            jsyn.rotation_errors(noisy, sc.R_gt, gauge))


def _close_rel(got, want, rel):
    want = np.asarray(want)
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("params", SCENES)
def test_create_matrix_arrays_parity(params):
    sc = tsyn.make_scene(**params)
    Cj, Aj = jcm.create_matrix_arrays(sc.weights, sc.edges, sc.landmarks)
    Ct, At = tcm.create_matrix_arrays(sc.weights, sc.edges, sc.landmarks,
                                      device="cpu")
    assert Ct.dtype == At.dtype == torch.float64
    _close_rel(Ct, Cj, 1e-10)
    _close_rel(At, Aj, 1e-10)
    assert torch.equal(Ct, Ct.T)


def test_create_matrix_arrays_mixed_parity():
    sc = tsyn.make_scene(n_cameras=20, n_points=80, obs_per_camera=10,
                         noise=0.1, seed=2)
    Cj, Aj = jcm.create_matrix_arrays(sc.weights, sc.edges, sc.landmarks,
                                      precision="mixed")
    Ct, At = tcm.create_matrix_arrays(sc.weights, sc.edges, sc.landmarks,
                                      precision="mixed", device="cpu")
    assert Ct.dtype == torch.float64
    _close_rel(Ct, Cj, 1e-4)
    _close_rel(At, Aj, 1e-4)
    C64, _ = tcm.create_matrix_arrays(sc.weights, sc.edges, sc.landmarks,
                                      device="cpu")
    _close_rel(Ct, C64.numpy(), 1e-4)


def test_create_matrix_writes_reference_files(tmp_path):
    sc = tsyn.make_scene(n_cameras=6, n_points=40, obs_per_camera=20, seed=4)
    C, Abar = tcm.create_matrix(sc.weights, sc.edges, sc.landmarks,
                                str(tmp_path), device="cpu")
    Q, _ = load_matrix_from_bin(os.path.join(tmp_path, "Q.bin"))
    A, _ = load_matrix_from_bin(os.path.join(tmp_path, "Abar.bin"))
    np.testing.assert_array_equal(Q, C.numpy())
    np.testing.assert_array_equal(A, Abar.numpy())
    Cj, _ = jcm.create_matrix_arrays(sc.weights, sc.edges, sc.landmarks)
    _close_rel(Q, Cj, 1e-10)
