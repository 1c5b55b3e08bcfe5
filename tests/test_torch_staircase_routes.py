"""Every route of a staircase rank through the one ``staircase._rank``:
``xmtpu_torch`` against ``xmtpu`` on the host.

The scene refutes rank 3 and certifies rank 4 after the escape linesearch,
on the dense matrix and on ``SchurQ`` alike.  Each route must reach the
reference's rank, status and certificate, and its optimum.  The references
are the JAX package's dense solves of the same problem, in f64 and in the
mixed ladder (its implicit and two-float solves reach the same optimum, at
several times the compile time).  The primals are held to the tolerances
of the files that hold each route already: the f64 routes to ``rtol 1e-9``
(``test_torch_sharding.py``), the mixed ladder to ``1e-5``
(``test_torch_staircase_mixed.py``), the two-float stage to its noise floor
(``0.3``, ``test_torch_staircase_implicit.py``).  With ``chunk=2`` the f32
phase outruns its first chunk.

The warm-radius rule (``trust_region._ladder``): the f64 stage after an f32
phase starts from that phase's final radius, floored at ``delta_bar *
1e-3``, on a whole dense matrix whose f32 phase ended within its first
chunk; from ``delta_bar / 8`` everywhere else.
"""

import numpy as np
import pytest
import torch

from xmtpu.assembly.creatematrix import create_matrix_arrays
from xmtpu.pipeline.synthetic import make_scene
from xmtpu.solver.staircase import solve_arrays as j_solve
from xmtpu_torch.ops.schurq import SchurQ as TQ
from xmtpu_torch.parallel import mesh as tmesh
from xmtpu_torch.solver import trust_region as tr
from xmtpu_torch.solver.staircase import solve_arrays as t_solve

CPU = "cpu"
SCENE = dict(n_cameras=36, n_points=140, obs_per_camera=12, noise=0.35,
             seed=1)
MIX = dict(precision="mixed", inner_f32=True)

# route: (operator, solve settings, primal rtol)
ROUTES = {
    "dense_f64": ("dense", dict(tol=1e-7), 1e-9),
    "dense_mixed_inner_f32": ("dense", dict(tol=1e-6, **MIX), 1e-5),
    "dense_mixed_chunk2": ("dense", dict(tol=1e-6, chunk=2, **MIX), 1e-5),
    "schurq_mixed": ("schurq", dict(tol=1e-6, precision="mixed"), 1e-5),
    "schurq_edge_tf_mixed": ("schurq", dict(tol=1e-6, edge_tf=True, **MIX),
                             0.3),
    "sharded_dense": ("sharded", dict(tol=1e-7), 1e-9),
}


@pytest.fixture(scope="module")
def problem():
    sc = make_scene(**SCENE)
    args = (sc.weights, sc.edges, sc.landmarks)
    C, _ = create_matrix_arrays(*args)
    return np.array(C), TQ.build(*args, device=CPU)


@pytest.fixture(scope="module")
def references(problem):
    """The JAX package's dense solves, by precision, made once."""
    cache = {}

    def get(precision):
        if precision not in cache:
            kw = dict(tol=1e-7) if precision == "f64" else dict(tol=1e-6,
                                                                 **MIX)
            cache[precision] = j_solve(problem[0], max_rank=6, lam=0.0,
                                       verbose=False, **kw)
        return cache[precision]
    return get


def _solve(kind, problem, kw):
    C, Qt = problem
    kw = dict(kw, max_rank=6, lam=0.0, verbose=False)
    if kind == "sharded":
        return tmesh.solve_arrays_sharded(tmesh.make_mesh(8, platform=CPU), C,
                                          **kw)
    return t_solve(C if kind == "dense" else Qt, device=CPU, **kw)


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_matches_reference(problem, references, route):
    kind, kw, rtol = ROUTES[route]
    ref = references(kw.get("precision", "f64"))
    got = _solve(kind, problem, kw)
    assert got.certified and bool(ref.certified)
    assert (got.rank, got.status) == (ref.rank, ref.status) == (4, 1)
    np.testing.assert_allclose(got.primal, float(ref.primal), rtol=rtol)
    assert [s["rank"] for s in got.stages] == [3, 4]
    assert [s["certified"] for s in got.stages] == [False, True]
    path = got.stages[-1]["cert_path"]
    assert (path == "dense") == (kind == "dense")
    assert "fused" not in got.stages[-1]
    assert sum(s["outer"] for s in got.stages) == got.outer_iters
    assert sum(s["inner"] for s in got.stages) == got.total_inner
    if route == "dense_f64":
        # the same f64 solve takes the reference's decisions exactly
        assert (got.outer_iters, got.total_inner) == (ref.outer_iters,
                                                      ref.total_inner)


def _recorded(monkeypatch):
    """Spies on ``_init_state`` and ``_run_chunk``: their events in order,
    ``("init", dtype, rank, radius)`` and ``("chunk", dtype, k before, k
    after, done, radius)``."""
    events = []
    init, run = tr._init_state, tr._run_chunk

    def spy_init(Q, R0, *args):
        st = init(Q, R0, *args)
        events.append(("init", R0.dtype, R0.shape[2], st.delta))
        return st

    def spy_run(Q, st, *args):
        out = run(Q, st, *args)
        events.append(("chunk", out.R.dtype, st.k, out.k, out.done,
                       out.delta))
        return out

    monkeypatch.setattr(tr, "_init_state", spy_init)
    monkeypatch.setattr(tr, "_run_chunk", spy_run)
    return events


@pytest.mark.parametrize("route,warm", [("dense_mixed_inner_f32", True),
                                        ("dense_mixed_chunk2", False),
                                        ("schurq_mixed", False)])
def test_stage_start_radius(problem, route, warm, monkeypatch):
    kind, kw, _ = ROUTES[route]
    events = _recorded(monkeypatch)
    res = _solve(kind, problem, kw)
    assert res.certified and res.rank == 4
    n = problem[0].shape[0] // 3
    starts = 0
    for i, ev in enumerate(events):
        if ev[0] != "init" or ev[1] != torch.float64:
            continue
        o = ev[2]
        delta_bar = np.sqrt(float(n * (3 * o - 6) + n - 1))
        # the f32 phase before it: its init, then its chunks
        f32 = [e for e in events[:i] if e[1] == torch.float32]
        first = next(e for e in reversed(f32) if e[0] == "init")
        first_chunk = f32[f32.index(first) + 1]
        assert first_chunk[0] == "chunk" and first_chunk[2] == 0
        # every rank's f32 phase ends within the default chunk, and outruns
        # a chunk of two outer iterations
        assert first_chunk[4] == (kw.get("chunk") is None)
        if warm:
            want = max(np.float64(first_chunk[5]), delta_bar * 1e-3)
            assert want < delta_bar / 8
        else:
            want = np.float64(delta_bar) / np.float64(8.0)
        assert ev[3] == want
        starts += 1
    assert starts == 2     # ranks 3 and 4
