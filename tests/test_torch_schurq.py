"""The implicit operator family (``ops/schurq.py``, two-float ``ops/qop.py``):
``xmtpu_torch`` against ``xmtpu`` on the same numpy scenes, host only.

Tolerances: the exact f64 operator and its pieces agree to ``rtol 1e-9``
(``VT_inv`` to ``1e-10``, as ``tests/test_schurq.py`` holds its own builds);
a reference operator carried across by ``convert.schurq_from_numpy`` applies
to ``1e-12``; the f32-pair operators with bands set (the reference in
Pallas interpret mode, the port through ``segsum``'s plain twin, which it
takes on the host whatever the bands) agree within ``1e-6`` of the output's
norm, their documented noise floor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmtpu.assembly.creatematrix import create_matrix_arrays
from xmtpu.ops import qop as jqop
from xmtpu.ops import schurq as jsq
from xmtpu.pipeline.synthetic import make_scene
from xmtpu_torch.convert import schurq_from_numpy
from xmtpu_torch.ops import qop as tqop
from xmtpu_torch.ops import schurq as tsq

CPU = "cpu"


@pytest.fixture(scope="module")
def problem():
    scene = make_scene(n_cameras=8, n_points=40, obs_per_camera=20,
                       noise=1e-3, seed=77)
    C, Abar = create_matrix_arrays(scene.weights, scene.edges, scene.landmarks)
    Qj = jsq.SchurQ.build(scene.weights, scene.edges, scene.landmarks)
    Qt = tsq.SchurQ.build(scene.weights, scene.edges, scene.landmarks,
                          device=CPU)
    return scene, np.asarray(C), np.asarray(Abar), Qj, Qt


def _rng_y(seed, rows, o):
    return np.random.default_rng(seed).normal(size=(rows, o))


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(
        np.asarray(b))


@pytest.mark.parametrize("vt_build", ["chol", "ns"])
def test_vt_inv_matches(problem, vt_build):
    scene, C, Abar, Qj, Qt = problem
    q = tsq.SchurQ.build(scene.weights, scene.edges, scene.landmarks,
                         vt_build=vt_build, device=CPU)
    np.testing.assert_allclose(q.VT_inv.numpy(), np.asarray(Qj.VT_inv),
                               rtol=1e-10, atol=1e-12)
    assert q.psd_ok and q.vt_resid_ratio < 2e3
    assert (q.band_l, q.band_f) == (0, 0)          # recorded only on request


def test_apply_and_recover_y_match(problem):
    scene, C, Abar, Qj, Qt = problem
    Y = _rng_y(0, C.shape[0], 4)
    got = Qt.apply(torch.tensor(Y)).numpy()
    np.testing.assert_allclose(got, np.asarray(Qj.apply(jnp.asarray(Y))),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got, C @ Y, rtol=1e-9, atol=1e-9)
    sR = _rng_y(1, C.shape[0], 3)
    y = Qt.recover_y(torch.tensor(sR)).numpy()
    np.testing.assert_allclose(y, np.asarray(Qj.recover_y(jnp.asarray(sR))),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(y, Abar @ sR, rtol=1e-8, atol=1e-9)
    np.testing.assert_array_equal(Qt.diag_blocks().numpy(),
                                  np.asarray(Qj.diag_blocks()))
    assert Qt.psd_by_construction and Qt.dim == Qj.dim


@pytest.mark.parametrize("kind", ["edge_f32", "two_float"])
def test_two_float_operators_with_bands(problem, kind):
    """Bands set: the reference runs its Pallas kernel in interpret mode,
    the port ``segsum.sorted_segment_sum``'s plain twin."""
    scene, C, Abar, Qj, Qt = problem
    qj = getattr(Qj, kind)(pallas=True)
    qt = getattr(Qt, kind)(pallas=True)
    assert (qt.band_l, qt.band_f) == (qj.band_l, qj.band_f) > (0, 0)
    Y = _rng_y(7, C.shape[0], 4)
    got = qt.apply(torch.tensor(Y)).numpy()
    ref = np.asarray(qj.apply(jnp.asarray(Y)))
    assert got.dtype == np.float64
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-6
    assert _rel(got, C @ Y) < 1e-5
    # without bands recorded, the port's applies run the same sums
    plain = getattr(Qt, kind)(pallas=False)
    assert (plain.band_l, plain.band_f) == (0, 0)
    assert _rel(plain.apply(torch.tensor(Y)).numpy(), ref) < 1e-6
    y = qt.recover_y(torch.tensor(Y[:, :3])).numpy()
    assert _rel(y, np.asarray(qj.recover_y(jnp.asarray(Y[:, :3])))) < 1e-6


def test_with_pallas_f32_cast(problem):
    """``with_pallas`` sets the bands; a cast keeps them, clears the PSD
    claim, and its f32 applies match the reference's f32 cast."""
    scene, C, Abar, Qj, Qt = problem
    qp = Qt.with_pallas(interpret=True)
    jp = Qj.with_pallas(interpret=True)
    assert (qp.band_l, qp.band_f) == (jp.band_l, jp.band_f)
    q32 = tqop.cast_qop(qp, torch.float32)
    assert (q32.band_l, q32.band_f) == (qp.band_l, qp.band_f)
    assert not q32.psd_by_construction and q32.Q1.dtype == torch.float32
    assert q32.f_l.dtype == torch.int64 and q32.bounds_l.dtype == torch.int32
    assert tqop.cast_qop(qp, torch.float64).psd_by_construction
    Y = _rng_y(0, C.shape[0], 3).astype(np.float32)
    got = q32.apply(torch.tensor(Y)).numpy()
    ref = np.asarray(jqop.cast_qop(jp, jnp.float32).apply(jnp.asarray(Y)))
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
    # f64 applies are unchanged by the bands
    Y64 = _rng_y(1, C.shape[0], 3)
    np.testing.assert_array_equal(qp.apply(torch.tensor(Y64)).numpy(),
                                  Qt.apply(torch.tensor(Y64)).numpy())


@pytest.mark.parametrize("kind,rtol", [("SchurQ", 1e-12),
                                       ("SchurQEdgeF32", 1e-12),
                                       ("SchurQTF", 1e-6)])
def test_convert_carried_operator_applies_like_reference(problem, kind, rtol):
    """The exact operator (and the f64-GEMM mixed one) to 1e-12; the fully
    two-float one runs f32 GEMMs, whose accumulation order differs between
    the libraries: its noise floor, 1e-6 of the output's norm."""
    scene, C, Abar, Qj, Qt = problem
    qj = {"SchurQ": Qj, "SchurQEdgeF32": Qj.edge_f32(pallas=False),
          "SchurQTF": Qj.two_float(pallas=False)}[kind]
    qt = schurq_from_numpy(qj, device=CPU)
    assert type(qt).__name__ == kind
    np.testing.assert_array_equal(qt.bounds_l.numpy(), Qt.bounds_l.numpy())
    np.testing.assert_array_equal(qt.bounds_f.numpy(), Qt.bounds_f.numpy())
    Y = _rng_y(3, C.shape[0], 4)
    got = qt.apply(torch.tensor(Y)).numpy()
    ref = np.asarray(qj.apply(jnp.asarray(Y)))
    if rtol < 1e-6:
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol)
    else:
        assert _rel(got, ref) < rtol


def test_chunked_and_pair_grams_match_slab():
    scene = make_scene(n_cameras=25, n_points=90, obs_per_camera=30,
                       noise=1e-3, seed=3)
    args = (scene.weights, scene.edges, scene.landmarks)
    q_slab = tsq.SchurQ.build(*args, landmark_chunk=0, device=CPU)
    q_chunk = tsq.SchurQ.build(*args, landmark_chunk=17, device=CPU)
    j_chunk = jsq.SchurQ.build(*args, landmark_chunk=17)
    for got in (q_chunk.VT_inv, q_slab.VT_inv):
        np.testing.assert_allclose(got.numpy(), np.asarray(j_chunk.VT_inv),
                                   rtol=1e-10, atol=1e-12)
    # build() takes the host pair route at this size: hold the chunked
    # Gram route directly
    edges = np.asarray(scene.edges)
    w = np.asarray(scene.weights, np.float64)
    f, l = edges[:, 0].astype(np.int64) - 1, edges[:, 1].astype(np.int64) - 1
    N, M = int(f.max()) + 1, int(l.max()) + 1
    ord_l = np.lexsort((f, l))
    bounds_l = np.searchsorted(l[ord_l], np.arange(M + 1)).astype(np.int32)
    g_ref = np.asarray(jsq._vt_gram_chunked(w, f, l, ord_l, bounds_l, N, M,
                                            17))
    g = tsq._vt_gram_chunked(w, f, l, ord_l, bounds_l, N, M, 17, CPU)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-12, atol=1e-13)
    np.testing.assert_array_equal(
        tsq._vt_gram_pairs(w, f, l, ord_l, bounds_l, N, M),
        jsq._vt_gram_pairs(w, f, l, ord_l, bounds_l, N, M))


def test_vt_inv_mixed_conditioning():
    """cond 1e5: Newton-Schulz reaches a near-f64 solve under the fallback
    threshold; cond 1e8: the residual ratio says fall back (as the
    reference's)."""
    rng = np.random.default_rng(11)
    B = rng.standard_normal((100, 100))
    _, V = np.linalg.eigh(B @ B.T)
    A = (V * np.geomspace(1e-5, 1.0, 100)) @ V.T
    X, ratio = tsq._vt_inv_mixed(torch.tensor(A))
    assert ratio < 2e3
    b = rng.standard_normal(100)
    x_star = np.linalg.solve(A, b)
    assert np.linalg.norm(X.numpy() @ b - x_star) / np.linalg.norm(
        x_star) < 1e-10
    rng = np.random.default_rng(13)
    B = rng.standard_normal((60, 60))
    _, V = np.linalg.eigh(B @ B.T)
    A = (V * np.geomspace(1e-8, 1.0, 60)) @ V.T
    _, ratio_ref = jsq._vt_inv_mixed(jnp.asarray(A))
    _, ratio = tsq._vt_inv_mixed(torch.tensor(A))
    assert ratio > 2e3 and float(ratio_ref) > 2e3


def test_pad_cameras(problem):
    scene, C, Abar, Qj, Qt = problem
    n = Qt.n_cameras
    Y = _rng_y(0, 3 * n, 4)
    Yp = np.concatenate([Y, np.zeros((9, 4))])
    for qt, qj in ((Qt, Qj), (Qt.edge_f32(pallas=True),
                              Qj.edge_f32(pallas=True))):
        p = tsq.pad_cameras(qt, n + 3)
        assert p.n_cameras == n + 3 and p.bounds_f.shape == (n + 4,)
        out = p.apply(torch.tensor(Yp)).numpy()
        np.testing.assert_allclose(out[:3 * n], qt.apply(
            torch.tensor(Y)).numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(out[3 * n:], 0.0)
        ref = np.asarray(jsq.pad_cameras(qj, n + 3).apply(jnp.asarray(Yp)))
        assert _rel(out, ref) < 1e-6


def test_operator_error_estimate(problem):
    scene, C, Abar, Qj, Qt = problem
    qtf = Qt.two_float(pallas=False)
    eta = tsq.operator_error_estimate(Qt, qtf)
    eta_ref = jsq.operator_error_estimate(Qj, Qj.two_float(pallas=False))
    assert 0.0 <= eta < 1e-4 * np.linalg.norm(C, 2)
    v = _rng_y(6, C.shape[0], 1)
    v /= np.linalg.norm(v)
    err = np.linalg.norm((qtf.apply(torch.tensor(v))
                          - Qt.apply(torch.tensor(v))).numpy())
    assert eta >= 0.3 * err
    # other start vector, same operator error to its order of magnitude
    assert 0.1 * eta_ref <= eta <= 10.0 * eta_ref


def test_dense_two_float(problem):
    scene, C, Abar, Qj, Qt = problem
    Y = _rng_y(11, C.shape[0], 5)
    qd = tqop.dense_two_float(tqop.DenseQ(torch.tensor(C)))
    got = qd.apply(torch.tensor(Y)).numpy()
    ref = np.asarray(jqop.dense_two_float(jnp.asarray(C)).apply(
        jnp.asarray(Y)))
    assert _rel(got, C @ Y) < 1e-6
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(
        ref).max())
    assert qd.diag_blocks().shape == (Qt.n_cameras, 3, 3)
    h, lo = tqop.split_f32(torch.tensor(C))
    hj, loj = jqop.split_f32(jnp.asarray(C))
    np.testing.assert_array_equal(h.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(loj))
