"""The pipeline around the implicit solve (``pipeline/graph.py``,
``recover.py``, ``xm2.py``, ``synthetic.make_scene_window``,
``utils/timer.py``, the native union-find): ``xmtpu_torch`` against
``xmtpu``, host only.

Tolerances: the view-graph cleanup and the scene generator give identical
arrays; recovery agrees to ``rtol 1e-7`` (both packages solve the same f64
problem through different libraries); ``xm2_solve`` implicit against dense
inside the port at ``tests/test_schurq.py``'s own tolerances (scales
``rtol 1e-5``, rotations ``rtol 1e-4, atol 1e-6``).
"""

import numpy as np
import pytest
import torch

from xmtpu.assembly.creatematrix import create_matrix_arrays as j_create
from xmtpu.ops.schurq import SchurQ as JQ
from xmtpu.pipeline import graph as jgraph
from xmtpu.pipeline import recover as jrec
from xmtpu.pipeline import synthetic as jsyn
from xmtpu.pipeline import xm2 as jxm2
from xmtpu.solver.staircase import solve_arrays as j_solve
from xmtpu_torch import runtime as trt
from xmtpu_torch.ops.schurq import SchurQ as TQ
from xmtpu_torch.pipeline import graph as tgraph
from xmtpu_torch.pipeline import recover as trec
from xmtpu_torch.pipeline import synthetic as tsyn
from xmtpu_torch.pipeline import xm2 as txm2
from xmtpu_torch.utils.timer import PhaseTimer

CPU = "cpu"


@pytest.mark.parametrize("long_range", [0, 4])
def test_make_scene_window_identical(long_range):
    kw = dict(n_cameras=50, n_points=160, obs_per_camera=12, noise=1e-3,
              seed=4, long_range=long_range)
    for a, b in zip(tsyn.make_scene_window(**kw),
                    jsyn.make_scene_window(**kw)):
        np.testing.assert_array_equal(a, b)


def _messy_scene():
    """Two disjoint scenes (the second smaller), a sparse frame and a
    landmark seen once: every branch of the cleanup runs."""
    a = tsyn.make_scene(n_cameras=14, n_points=50, obs_per_camera=15, seed=2)
    b = tsyn.make_scene(n_cameras=5, n_points=20, obs_per_camera=12, seed=3)
    eb = b.edges + np.array([a.N, a.M])
    edges = np.concatenate([a.edges, eb, [[a.N + b.N + 1, 1],
                                          [1, a.M + b.M + 1]]])
    E = len(edges)
    rng = np.random.default_rng(0)
    return (edges, rng.normal(size=(E, 3)), rng.uniform(0.5, 2.0, E),
            rng.integers(0, 255, (E, 3)).astype(float), a.N + b.N + 1,
            a.M + b.M + 1)


def test_checklandmarks_identical(capsys):
    edges, x, w, rgb, N, M = _messy_scene()
    got = tgraph.checklandmarks(edges, x, w, rgb, N, M)
    ref = jgraph.checklandmarks(edges, x, w, rgb, N, M)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert got[0][:, 0].max() < N and "Largest Component" in \
        capsys.readouterr().out
    f = edges[:, 0] - 1
    for a, b in zip(tgraph.delete_threshold(10, N, f),
                    jgraph.delete_threshold(10, N, f)):
        np.testing.assert_array_equal(a, b)


def test_connected_components_native_and_scipy(monkeypatch):
    edges, *_ , N, M = _messy_scene()
    u, v = edges[:, 0] - 1, edges[:, 1] - 1 + N
    n_native, lab_native = trt.connected_component_labels(u, v, N + M)
    assert trt.have_native()
    monkeypatch.setattr(trt, "_load", lambda: None)
    n_scipy, lab_scipy = trt.connected_component_labels(u, v, N + M)
    assert n_native == n_scipy
    # the same partition (labels may be numbered differently)
    pairs = set(zip(lab_native.tolist(), lab_scipy.tolist()))
    assert len(pairs) == n_native


@pytest.fixture(scope="module")
def solved():
    sc = jsyn.make_scene(n_cameras=8, n_points=40, obs_per_camera=20,
                         noise=1e-3, seed=77)
    C, Abar = j_create(sc.weights, sc.edges, sc.landmarks)
    Qj = JQ.build(sc.weights, sc.edges, sc.landmarks)
    Qt = TQ.build(sc.weights, sc.edges, sc.landmarks, device=CPU)
    res = j_solve(Qj, max_rank=4, tol=1e-8, verbose=False)
    return sc, np.asarray(C), np.asarray(Abar), Qj, Qt, res


def _rank4_factor(n, seed=5):
    """An orthonormal-row rank-4 factor: the SVD branch of the recovery."""
    rng = np.random.default_rng(seed)
    R = np.linalg.qr(rng.normal(size=(n, 4, 3)))[0].transpose(0, 2, 1)
    return R.reshape(3 * n, 4), np.exp(rng.normal(size=n) * 0.1)


def test_recover_matches_reference(solved):
    sc, C, Abar, Qj, Qt, res = solved
    cases = [(res.R, res.s_ex, 0.0), (*_rank4_factor(sc.N), 0.7)]
    for R, s, lam in cases:
        want = jrec.recover_XM_implicit(Qj, R, s, lam, verbose=False)
        for got in (trec.recover_XM_implicit(Qt, R, s, lam, verbose=False),
                    trec.recover_XM(torch.tensor(C), R, s, torch.tensor(Abar),
                                    lam, verbose=False),
                    trec.recover_XM(C, R, s, Abar, lam, verbose=False)):
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9)
        for a, b in zip(trec.recover_XM(C, R, s, Abar, lam, verbose=False),
                        jrec.recover_XM(C, R, s, Abar, lam, verbose=False)):
            np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9)


def test_residuals_and_choose_implicit(solved):
    sc, C, Abar, Qj, Qt, res = solved
    R_real, s_real, p_est, t_est = jrec.recover_XM(C, res.R, res.s_ex, Abar,
                                                   0.0, verbose=False)
    args = (sc.edges, sc.weights, sc.landmarks, R_real, s_real, t_est, p_est)
    for rel in (False, True):
        np.testing.assert_array_equal(txm2.xm2_residuals(*args, relative=rel),
                                      jxm2.xm2_residuals(*args, relative=rel))
    for N, M, budget in ((1934, 8000, None), (20000, 100000, None),
                         (1934, 8000, 10 << 20), (6144, 24576, None)):
        assert txm2.choose_implicit(N, M, budget) == jxm2.choose_implicit(
            N, M, budget)
    assert txm2.choose_implicit(6144, 24576)       # scene C's size


def test_assemble_operator_choice(solved):
    sc, C, Abar, Qj, Qt, res = solved
    op, ab, impl = txm2._assemble_operator(sc.weights, sc.edges, sc.landmarks,
                                           False, True, device=CPU)
    assert impl and ab is None and isinstance(op, TQ)
    op, ab, impl = txm2._assemble_operator(sc.weights, sc.edges, sc.landmarks,
                                           False, "auto", device=CPU)
    assert not impl and op.psd_by_construction
    np.testing.assert_allclose(op.C.numpy(), C, rtol=1e-10, atol=1e-10)


def test_xm2_implicit_matches_dense():
    sc = tsyn.make_scene(n_cameras=8, n_points=40, obs_per_camera=20,
                         noise=1e-3, seed=77)
    kw = dict(max_rank=4, tol=1e-7, verbose=False, device=CPU)

    def run(**extra):
        return txm2.xm2_solve(sc.edges.copy(), sc.weights.copy(),
                              sc.landmarks.copy(), sc.rgbs.copy(), sc.N,
                              sc.M, **kw, **extra)

    timer = PhaseTimer()
    a = run()
    b = run(implicit=True, timer=timer)
    np.testing.assert_allclose(a.s_real, b.s_real, rtol=1e-5)
    np.testing.assert_allclose(a.R_real, b.R_real, rtol=1e-4, atol=1e-6)
    ref = jxm2.xm2_solve(sc.edges.copy(), sc.weights.copy(),
                         sc.landmarks.copy(), sc.rgbs.copy(), sc.N, sc.M,
                         implicit=True, max_rank=4, tol=1e-7, verbose=False)
    np.testing.assert_allclose(b.R_real, ref.R_real, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(b.indices_all, ref.indices_all)
    assert b.lam == ref.lam
    assert set(timer.totals) == {"clean1", "pass1_assemble",
                                 "pass1_solve_recover", "residuals", "clean2",
                                 "pass2_assemble", "pass2_probe",
                                 "pass2_solve_recover"}
    assert all(timer.counts[k] == 1 for k in timer.totals)
    assert "pass2_probe" in timer.report()
