"""The certified rank staircase on the production setting,
``precision="mixed", inner_f32=True``: ``xmtpu_torch`` against ``xmtpu``.

The f32 phase of every rank runs its tCG iterations through
``fused_tcg.inner_tcg_fused`` on a card and through the generic loop on the
host (the reference's CPU route), so here both packages take the generic
route.  Scene A must certify at rank 4 in both, with primals within 1e-5 of
each other; the f32 phase rounds differently, the f64 polish settles it.
"""

import numpy as np
import torch

from xmtpu.assembly.creatematrix import create_matrix_arrays
from xmtpu.pipeline.synthetic import make_scene
from xmtpu.solver.staircase import solve_arrays as j_solve
from xmtpu_torch.solver import staircase as ts

SCENE_A = dict(n_cameras=120, n_points=400, obs_per_camera=10, noise=0.35,
               seed=1)


def test_scene_a_certifies_rank4_mixed():
    sc = make_scene(**SCENE_A)
    C, _ = create_matrix_arrays(sc.weights, sc.edges, sc.landmarks)
    C = np.array(C)
    kw = dict(max_rank=6, tol=1e-6, precision="mixed", inner_f32=True,
              verbose=False)
    ref = j_solve(C, **kw)
    got = ts.solve_arrays(C, device="cpu", **kw)
    for r in (ref, got):
        assert r.certified and r.rank == 4 and r.status == 1
    np.testing.assert_allclose(got.primal, ref.primal, rtol=1e-5)
    np.testing.assert_allclose(got.primal, 66.46483, rtol=1e-4)
    assert got.stages[-1]["fused"] and got.stages[-1]["cert_s"] > 0.0


def test_mixed_through_the_fused_loop_on_the_host(monkeypatch):
    """The card's route, with the kernels' plain twins: every f32 tCG loop
    goes through ``fused_tcg.inner_tcg_fused``; the staircase still
    certifies scene A at rank 4."""
    from xmtpu_torch.ops import fused_tcg
    from xmtpu_torch.solver import trust_region as tr

    generic = tr._inner_tcg
    calls = []

    def routed(qmul, R, *args, minv=None):
        if minv is not None and R.dtype == torch.float32:
            calls.append(fused_tcg.dense_matrix(qmul, R.shape[0]) is not None)
            return fused_tcg.inner_tcg_fused(qmul, R, *args, minv)
        return generic(qmul, R, *args, minv=minv)

    monkeypatch.setattr(tr, "_inner_tcg", routed)
    sc = make_scene(**SCENE_A)
    C, _ = create_matrix_arrays(sc.weights, sc.edges, sc.landmarks)
    got = ts.solve_arrays(np.array(C), max_rank=6, tol=1e-6,
                          precision="mixed", inner_f32=True, verbose=False,
                          device="cpu")
    assert got.certified and got.rank == 4
    np.testing.assert_allclose(got.primal, 66.46483, rtol=1e-4)
    assert calls and all(calls)        # n = 120: the dense variant
