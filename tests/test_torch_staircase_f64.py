"""The certified rank staircase, f64: ``xmtpu_torch`` against ``xmtpu``.

Scene A is the repository's saddle-escape anchor (``tests/test_scale.py``):
rank 3 is refuted and the escape along the certificate direction certifies
rank 4.  Both packages must certify at rank 4 with primals within 1e-5 of
each other (and within the anchor's own 1e-4 of 66.46483).  Trajectories may
part after tens of outer iterations (rounding in another summation order),
so iteration counts are compared only on a short solve.
"""

import numpy as np
import pytest

from xmtpu.assembly.creatematrix import create_matrix_arrays
from xmtpu.pipeline.synthetic import make_scene
from xmtpu.solver.staircase import solve_arrays as j_solve
from xmtpu_torch.solver import staircase as ts

SCENE_A = dict(n_cameras=120, n_points=400, obs_per_camera=10, noise=0.35,
               seed=1)


def _C(params):
    sc = make_scene(**params)
    C, _ = create_matrix_arrays(sc.weights, sc.edges, sc.landmarks)
    return np.array(C)


def test_scene_a_certifies_rank4_f64():
    C = _C(SCENE_A)
    ref = j_solve(C, max_rank=6, tol=1e-6, verbose=False)
    got = ts.solve_arrays(C, max_rank=6, tol=1e-6, verbose=False,
                          device="cpu")
    for r in (ref, got):
        assert r.certified and r.rank == 4 and r.status == 1
    np.testing.assert_allclose(got.primal, ref.primal, rtol=1e-5)
    np.testing.assert_allclose(got.primal, 66.46483, rtol=1e-4)
    assert [s["rank"] for s in got.stages] == [3, 4]
    assert [s["certified"] for s in got.stages] == [False, True]
    assert got.R.shape == (3 * 120, 4) and got.s_ex[0] == 1.0


@pytest.mark.parametrize("rank3_only", [False, True])
def test_short_solve_identical_decisions(rank3_only):
    C = _C(dict(n_cameras=10, n_points=40, obs_per_camera=12, noise=0.05,
                seed=3))
    ref = j_solve(C, max_rank=5, tol=1e-7, rank3_only=rank3_only,
                  verbose=False)
    got = ts.solve_arrays(C, max_rank=5, tol=1e-7, rank3_only=rank3_only,
                          verbose=False, device="cpu")
    assert (got.rank, got.status, got.certified) == \
        (ref.rank, ref.status, bool(ref.certified))
    assert (got.outer_iters, got.total_inner) == \
        (ref.outer_iters, ref.total_inner)
    np.testing.assert_allclose(got.primal, ref.primal, rtol=1e-9)
    if not rank3_only:
        np.testing.assert_allclose(got.gap, ref.gap, rtol=1e-4,
                                   atol=1e-8 * abs(ref.primal))
