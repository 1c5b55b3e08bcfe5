"""The certified staircase on the implicit operator: ``xmtpu_torch`` against
``xmtpu`` (``solve_arrays(SchurQ)``), host only.

Each setting must give the same certified flag and rank in both packages.
Primals: the exact f64 stages agree to ``rtol 1e-6`` (the tolerance
``tests/test_schurq.py`` holds the implicit staircase to against the dense
one); stages on the two-float operators stop at their own noise floor, and
at this noise-floor primal the certificate accepts through the size bound,
so both packages' own tolerance applies: ``rtol 0.3``
(``tests/test_schurq.py:163``).
"""

import numpy as np
import pytest
import torch

from xmtpu.ops.schurq import SchurQ as JQ
from xmtpu.pipeline.synthetic import make_scene
from xmtpu.solver.staircase import solve_arrays as j_solve
from xmtpu_torch.ops import manifold as tmf
from xmtpu_torch.ops.schurq import SchurQ as TQ
from xmtpu_torch.solver import checkpoint as tck
from xmtpu_torch.solver import trust_region as ttr
from xmtpu_torch.solver.staircase import solve_arrays as t_solve

CPU = "cpu"


@pytest.fixture(scope="module")
def ops():
    scene = make_scene(n_cameras=8, n_points=40, obs_per_camera=20,
                       noise=1e-3, seed=77)
    args = (scene.weights, scene.edges, scene.landmarks)
    return JQ.build(*args), TQ.build(*args, device=CPU)


SETTINGS = {
    "f64": (dict(tol=1e-8), 1e-6),
    "edge_f32": (dict(tol=1e-6, edge_f32=True, inner_f32=True), 0.3),
    "edge_f32_banded": (dict(tol=1e-6, edge_f32=True, edge_pallas=True), 0.3),
    "edge_tf_mixed": (dict(tol=1e-6, edge_tf=True, inner_f32=True,
                           precision="mixed"), 0.3),
}


@pytest.mark.parametrize("name", list(SETTINGS))
def test_staircase_matches_reference(ops, name):
    Qj, Qt = ops
    kw, rtol = SETTINGS[name]
    ref = j_solve(Qj, max_rank=4, lam=0.0, verbose=False, **kw)
    got = t_solve(Qt, max_rank=4, lam=0.0, verbose=False, device=CPU, **kw)
    assert got.certified == ref.certified is True
    assert got.rank == ref.rank and got.status == ref.status == 1
    np.testing.assert_allclose(got.primal, ref.primal, rtol=rtol, atol=1e-10)
    stage = got.stages[-1]
    assert stage["cert_path"] != "dense" and stage["cert_s"] > 0.0
    if name == "f64":
        # a short f64 solve takes the reference's decisions exactly
        assert (got.outer_iters, got.total_inner) == (ref.outer_iters,
                                                      ref.total_inner)
    else:
        # the fast stage's primal is re-read through the exact operator
        n = Qt.n_cameras
        R = torch.tensor(got.R).reshape(n, 3, got.rank)
        exact = float(tmf.objective(Qt.apply, R, torch.tensor(got.s_ex), 0.0))
        assert got.primal == pytest.approx(exact, rel=1e-12, abs=1e-15)


def test_resume_inside_a_rank(ops, tmp_path):
    """A mid-stage checkpoint of an implicit solve resumes to the same
    certified optimum; a file without ``QsR`` rebuilds it from the
    operator."""
    Qj, Qt = ops
    path = str(tmp_path / "stair")
    full = t_solve(Qt, max_rank=4, tol=1e-8, verbose=False, device=CPU,
                   chunk=2, checkpoint_path=path)
    mid = tck.load_checkpoint(path + ".mid")
    assert isinstance(mid, tck.TRCheckpoint) and mid.k_done >= 2
    st = tck.tr_state_from_checkpoint(mid, Q=Qt, device=CPU)
    sR = tmf.flatten(tmf.scale_blocks(st.R, st.s_ex))
    want = tmf.unflatten(2.0 * Qt.apply(sR))
    no_qsr = mid._replace(state_arrays={k: v for k, v in
                                        mid.state_arrays.items()
                                        if k != "QsR"})
    rebuilt = tck.tr_state_from_checkpoint(no_qsr, Q=Qt, device=CPU)
    torch.testing.assert_close(rebuilt.QsR, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(st.QsR, want, rtol=1e-9, atol=1e-12)
    res = t_solve(Qt, max_rank=4, tol=1e-8, verbose=False, device=CPU,
                  chunk=2, resume_from=path + ".mid")
    assert res.certified and res.rank == full.rank
    np.testing.assert_allclose(res.primal, full.primal, rtol=1e-6)


def test_trust_region_takes_the_operator(ops):
    """The trust region runs on the implicit operator unchanged: its
    diagonal blocks are ``Q1``; the f32 phase on its cast (no dense
    matrix for the fused loop)."""
    from xmtpu_torch.ops import fused_tcg
    from xmtpu_torch.ops.qop import cast_qop

    Qj, Qt = ops
    n = Qt.n_cameras
    q32 = cast_qop(Qt, torch.float32)
    assert fused_tcg.dense_matrix(q32.apply, n) is None
    assert q32.diag_blocks().dtype == torch.float32
    R0 = np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
    res = ttr.trust_region_solve_mixed(Qt, R0, np.ones(n), 0.0, 1e-8,
                                       device=CPU)
    assert res.primal == pytest.approx(t_solve(
        Qt, max_rank=3, tol=1e-8, rank3_only=True, verbose=False,
        device=CPU).primal, rel=1e-4)
