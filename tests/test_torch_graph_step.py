"""The f32 outer step's segments as CUDA graphs (``solver/graph_step.py``)
against the eager segments, both through ``trust_region._outer_step``.

The graph provider replays the eager provider's own segments on static
buffers, so both must give the same bits.  On the CPU the segments run
eagerly (``PhaseGraphs`` on CPU tensors) against ``EagerSegments`` with the
f32 tCG routed through ``fused_tcg.inner_tcg_fused`` as on the card; on the
card the captured route runs against the eager one, and the profiler's
``tcg_step`` kernels against the wrappers' count.

This file imports neither JAX nor ``xmtpu``, so it also runs on the machine
with the card:

    python -m pytest tests/test_torch_graph_step.py --noconftest -q
"""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from xmtpu_torch.assembly.creatematrix import create_matrix_arrays
from xmtpu_torch.ops import fused_tcg as ft
from xmtpu_torch.ops import manifold as mf
from xmtpu_torch.ops.qop import DenseQ, cast_qop
from xmtpu_torch.ops.schurq import SchurQ
from xmtpu_torch.parallel.sharded import split_dense
from xmtpu_torch.pipeline.synthetic import make_scene
from xmtpu_torch.solver import trust_region as tr
from xmtpu_torch.solver.graph_step import PhaseGraphs
from xmtpu_torch.solver.staircase import solve_arrays
from xmtpu_torch.utils import timer

SMALL = dict(n_cameras=40, n_points=300, obs_per_camera=30, noise=1e-2,
             seed=0)


def _phase(scene, o, device, seed=1):
    """The f32 phase's operator and first state at rank ``o`` on a scene,
    as the mixed ladder starts it: ``(q32, st, lam, gradtol, delta_bar,
    cfg)``.  Above rank 3 the frames start off the identity, seeded."""
    sc = make_scene(**scene)
    C, _ = create_matrix_arrays(sc.weights, sc.edges, sc.landmarks,
                                precision="f64", device=device)
    q32 = cast_qop(DenseQ(C), torch.float32)
    n = C.shape[0] // 3
    R0 = mf.identity_frames(n, o, dtype=torch.float32, device=device)
    if o > 3:
        g = torch.Generator().manual_seed(seed)
        R0 = mf.mgs_rows(R0 + 0.1 * torch.randn(R0.shape, generator=g)
                         .to(device))
    s0 = torch.ones((n,), dtype=torch.float32, device=device)
    cfg, gradtol = tr.TRConfig(chunk=100).f32_ladder(1e-3)
    delta_bar = np.float32(np.sqrt(n * (3 * o - 6) + n - 1))
    lam = np.float32(0.0)
    st = tr._init_state(q32, R0, s0, lam, delta_bar, cfg)
    return q32, st, lam, np.float32(gradtol), delta_bar, cfg


def _eager(q32, st, lam, gradtol, delta_bar, cfg, kmax=100):
    while not st.done and st.k < kmax:
        st = tr._outer_step(_eager_segments(q32, lam, cfg), st, gradtol,
                            delta_bar)
    return st


def _eager_segments(q32, lam, cfg):
    return tr.EagerSegments(q32.apply, lam, cfg, q32.diag_blocks())


def _assert_same(a, b):
    for name in ("R", "s_ex", "QsR"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name in ("loss", "delta", "k", "total_inner", "gradnorm",
                 "done_reason", "shrink_count", "collapse_count"):
        assert getattr(a, name) == getattr(b, name), name


def _routed_to_fused(monkeypatch):
    """The card's route on the host: the f32 preconditioned tCG solves
    through ``fused_tcg.inner_tcg_fused`` (its plain twins)."""
    generic = tr._inner_tcg

    def routed(qmul, R, *args, minv=None):
        if minv is not None and R.dtype == torch.float32:
            return ft.inner_tcg_fused(qmul, R, *args, minv)
        return generic(qmul, R, *args, minv=minv)

    monkeypatch.setattr(tr, "_inner_tcg", routed)


def _fake_cuda(t):
    """A stand-in with a CUDA tensor's dtype and device, for the route
    rule alone."""
    return SimpleNamespace(dtype=t.dtype, device=torch.device("cuda", 0))


# ---------------------------------------------------------------- the CPU --

def test_route_rule():
    q32, st, _, _, _, cfg = _phase(SMALL, 3, "cpu")
    R, QsR = st.R, st.QsR
    on_card = st._replace(R=_fake_cuda(R))
    card_q = DenseQ(_fake_cuda(q32.C))
    assert tr.graph_route(card_q, on_card, cfg)
    # every CPU run
    assert not tr.graph_route(q32, st, cfg)
    # an f64 carry, or an f64 operator
    f64 = st._replace(R=_fake_cuda(R.double()))
    assert not tr.graph_route(DenseQ(_fake_cuda(q32.C.double())), f64, cfg)
    assert not tr.graph_route(DenseQ(_fake_cuda(q32.C.double())), on_card,
                              cfg)
    # no carried 2 Q sR, no preconditioner
    assert not tr.graph_route(card_q, on_card._replace(QsR=None), cfg)
    assert not tr.graph_route(card_q, on_card,
                              tr.TRConfig(precondition=False))
    # the operator on another card
    other = DenseQ(SimpleNamespace(dtype=torch.float32,
                                   device=torch.device("cuda", 1)))
    assert not tr.graph_route(other, on_card, cfg)
    assert QsR is not None
    # SchurQ and a sharded dense operator (built on the host)
    sc = make_scene(n_cameras=8, n_points=40, obs_per_camera=20, noise=1e-3,
                    seed=0)
    sq = SchurQ.build(sc.weights, sc.edges, sc.landmarks, device="cpu")
    assert not tr.graph_route(sq, on_card, cfg)
    sharded = split_dense(q32.C, [torch.device("cpu")] * 2,
                          torch.device("cpu")).cast(torch.float32)
    assert not tr.graph_route(sharded, on_card, cfg)


@pytest.mark.parametrize("o", [3, 4])
@pytest.mark.parametrize("variant", ["dense", "split"])
def test_segments_are_the_eager_step(o, variant, monkeypatch):
    """A small scene's whole f32 phase through the one ``_outer_step``:
    the graph provider's segments, run eagerly on its static buffers, give
    the eager provider's bits, step by step."""
    if variant == "split":
        # the split variant at a host size: no n passes the dense gate
        monkeypatch.setattr(ft, "DENSE_MAX_N", 0)
    _routed_to_fused(monkeypatch)
    q32, st0, lam, gradtol, delta_bar, cfg = _phase(SMALL, o, "cpu")
    launches = (ft.tcg_step.launches, ft.tcg_step_dense.launches)
    a, b = st0, st0
    eager = _eager_segments(q32, lam, cfg)
    with contextlib.closing(PhaseGraphs(q32, st0, lam, cfg)) as phase:
        assert not phase.capture
        while not a.done and a.k < 100:
            a = tr._outer_step(eager, a, gradtol, delta_bar)
            b = tr._outer_step(phase, b, gradtol, delta_bar)
            _assert_same(a, b)
    assert a.done and a.k > 5 and a.total_inner > a.k
    assert b.R is not st0.R      # the phase stepped on its own buffers
    # the host takes the plain twins: no launch counted
    assert (ft.tcg_step.launches, ft.tcg_step_dense.launches) == launches


def test_chunk_on_the_host_is_the_eager_step(monkeypatch):
    """``_run_chunk`` on the host keeps the eager route: the same bits as
    the eager steps, and no replay counted."""
    _routed_to_fused(monkeypatch)
    q32, st0, lam, gradtol, delta_bar, cfg = _phase(SMALL, 3, "cpu")
    replays = timer.graph_replays.n
    a = _eager(q32, st0, lam, gradtol, delta_bar, cfg)
    b = tr._run_chunk(q32, st0, lam, gradtol, delta_bar, cfg, 100)
    _assert_same(a, b)
    assert timer.graph_replays.n == replays


def test_graph_replays_are_counted_per_rank():
    sc = make_scene(n_cameras=12, n_points=60, obs_per_camera=20,
                    noise=0.05, seed=2)
    C, _ = create_matrix_arrays(sc.weights, sc.edges, sc.landmarks,
                                precision="f64", device="cpu")
    res = solve_arrays(C, max_rank=6, tol=1e-6, precision="mixed",
                       inner_f32=True, verbose=False, device="cpu")
    assert res.certified and res.stages
    for stage in res.stages:
        assert stage["graph_replays"] == 0
        assert stage["host_reads"] > 0


def test_minv_cholesky_reads_nothing_back():
    """``_build_minv`` factors with ``cholesky_ex``, its ``info`` unread:
    the bits of the factorisation that checks, in both precisions."""
    sc = make_scene(**SMALL)
    C, _ = create_matrix_arrays(sc.weights, sc.edges, sc.landmarks,
                                precision="f64", device="cpu")
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.float64):
        q = cast_qop(DenseQ(C), dtype)
        s_ex = torch.tensor(rng.uniform(0.5, 1.5, size=C.shape[0] // 3),
                            dtype=dtype)
        for lam in (0.0, 0.3):
            minv, ms = tr._build_minv(q.diag_blocks(), s_ex, lam)
            M = 2.0 * (s_ex * s_ex)[:, None, None] * q.diag_blocks()
            t = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1).mean() / 3.0
            t = torch.maximum(t, torch.tensor(1e-300, dtype=dtype))
            M = M / t + 1e-4 * torch.eye(3, dtype=dtype)
            L = torch.linalg.cholesky(M)
            Linv = torch.linalg.solve_triangular(
                L, torch.eye(3, dtype=dtype).expand(M.shape), upper=False)
            assert torch.equal(minv, torch.einsum("nka,nkb->nab", Linv,
                                                  Linv))
            assert torch.isfinite(ms).all()


# --------------------------------------------------------------- the card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have "
                    "no CPU mode")
    return torch.device("cuda")


# the split variant at the benchmark's n (BAL-1936, landmarks cut), and the
# dense variant (n <= 512)
CARD = {"split": dict(n_cameras=1936, n_points=7744, obs_per_camera=60,
                      noise=1e-3, seed=0),
        "dense": dict(n_cameras=120, n_points=400, obs_per_camera=10,
                      noise=0.05, seed=1)}


def _tcg_events(fn):
    """``fn()`` under the profiler: the ``tcg_step`` and ``tcg_step_dense``
    kernels it recorded, and the wrappers' counts of the same.  The window
    opens with spin kernels, since the profiler may drop a window's first
    device events late in a process."""
    from torch.profiler import ProfilerActivity, profile

    before = (ft.tcg_step.launches, ft.tcg_step_dense.launches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(256):
            torch.cuda._sleep(1)
        out = fn()
        torch.cuda.synchronize()
    names = [e.name().replace(" ", "")
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    kern = [nm for nm in names if "tcg_step_kernel" in nm]
    dense = sum("true>" in nm or "Lb1E" in nm for nm in kern)
    seen = (len(kern) - dense, dense)
    counted = (ft.tcg_step.launches - before[0],
               ft.tcg_step_dense.launches - before[1])
    return out, seen, counted


@pytest.mark.cuda
@pytest.mark.parametrize("variant,o", [("split", 3), ("split", 4),
                                       ("dense", 3)])
def test_graph_route_is_the_eager_step_on_card(variant, o, cuda_device):
    q32, st0, lam, gradtol, delta_bar, cfg = _phase(CARD[variant], o,
                                                    cuda_device)
    assert tr.graph_route(q32, st0, cfg)
    eager = _eager(q32, st0, lam, gradtol, delta_bar, cfg)
    replays = timer.graph_replays.n
    graphed, seen, counted = _tcg_events(
        lambda: tr._run_chunk(q32, st0, lam, gradtol, delta_bar, cfg, 100))
    _assert_same(eager, graphed)
    assert eager.k > 5 and eager.total_inner > eager.k
    # the profiler saw every launch the wrappers counted, of one variant
    assert seen == counted
    assert counted[variant == "split"] == 0 and sum(counted) > 0
    # start and end every step, a product every split launch
    done = timer.graph_replays.n - replays
    assert done >= 2 * graphed.k + (counted[0] if variant == "split" else 0)
    # the graphs' own buffers went with them; the state is the phase's
    assert graphed.R.is_cuda and graphed.R is not st0.R
