"""The f32 outer step's segments as CUDA graphs (``solver/graph_step.py``)
against the eager segments, both through ``trust_region._outer_step``, on a
whole ``DenseQ`` and on a whole float32 ``SchurQ`` (the fused product).

The graph provider replays the eager provider's own segments on static
buffers, so both must give the same bits.  On the CPU the segments run
eagerly (``PhaseGraphs`` on CPU tensors) against ``EagerSegments`` with the
f32 tCG routed through ``fused_tcg.inner_tcg_fused`` as on the card, and on
``SchurQ`` once more through a host stand-in for a graph (a replay runs the
captured segment on the capture's buffers and counts nothing in Python),
which holds the counting rule: a replay adds what its capture run added to
each count (``utils.timer.counts``), and its products to
``applies_replayed``.  On the card the captured route runs against the
eager one, and the profiler's kernels against the wrappers' counts: every
``tcg_step``, and on ``SchurQ`` every fused product, with no segment-sum
kernel.

This file imports neither JAX nor ``xmtpu``, so it also runs on the machine
with the card:

    python -m pytest tests/test_torch_graph_step.py --noconftest -q
"""

import contextlib
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from xmtpu_torch.assembly.creatematrix import create_matrix_arrays
from xmtpu_torch.ops import fused_tcg as ft
from xmtpu_torch.ops import manifold as mf
from xmtpu_torch.ops import segsum as ss
from xmtpu_torch.ops.qop import DenseQ, cast_qop
from xmtpu_torch.ops.schurq import APPLY_SPAN, SchurQ, schurq_product
from xmtpu_torch.parallel.sharded import split_dense, split_schurq
from xmtpu_torch.pipeline.synthetic import make_scene, make_scene_window
from xmtpu_torch.solver import graph_step as gs
from xmtpu_torch.solver import trust_region as tr
from xmtpu_torch.solver.graph_step import PhaseGraphs
from xmtpu_torch.solver.staircase import solve_arrays
from xmtpu_torch.utils import timer

SMALL = dict(n_cameras=40, n_points=300, obs_per_camera=30, noise=1e-2,
             seed=0)
# tests/test_torch_implicit_window.py's window scene
WINDOW = dict(n_cameras=48, n_points=600, obs_per_camera=30, noise=1e-3,
              long_range=4, seed=0)
# the counts a replay adds to beside its capture's
REPLAYS = (timer.graph_replays, timer.applies_replayed)


def _phase(scene, o, device, seed=1):
    """The f32 phase's operator and first state at rank ``o`` on a scene,
    as the mixed ladder starts it: ``(q32, st, lam, gradtol, delta_bar,
    cfg)``."""
    sc = make_scene(**scene)
    C, _ = create_matrix_arrays(sc.weights, sc.edges, sc.landmarks,
                                precision="f64", device=device)
    return _first_state(cast_qop(DenseQ(C), torch.float32), o, seed)


def _window(device):
    """The window scene's ``SchurQ`` (float64)."""
    sc = make_scene_window(**WINDOW)
    return SchurQ.build(sc.weights, sc.edges, sc.landmarks, device=device)


def _first_state(q32, o, seed):
    """:func:`_phase`'s tuple on the f32 operator ``q32``.  Above rank 3
    the frames start off the identity, seeded."""
    n, device = q32.dim // 3, q32.device
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


def _fake_cuda(t, index=0):
    """A stand-in with a tensor's dtype on a CUDA device, for the route
    rule alone."""
    return SimpleNamespace(dtype=t.dtype, device=torch.device("cuda", index))


def _on_card(q, index=0):
    """``q`` with its ``inv_q3`` (what the route rule reads of the
    implicit operators) on a card."""
    q = copy.copy(q)
    q.inv_q3 = _fake_cuda(q.inv_q3, index)
    return q


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
    # a whole f32 SchurQ on the carry's card: the fused product's route
    s32 = cast_qop(sq, torch.float32)
    st32 = _first_state(s32, 3, 1)[1]
    card32 = st32._replace(R=_fake_cuda(st32.R))
    assert tr.graph_route(_on_card(s32), card32, cfg)
    # the preconditioner, the carried 2 Q sR and an f32 carry still hold
    assert not tr.graph_route(_on_card(s32), card32._replace(QsR=None), cfg)
    assert not tr.graph_route(_on_card(s32), card32,
                              tr.TRConfig(precondition=False))
    assert not tr.graph_route(
        _on_card(s32), st32._replace(R=_fake_cuda(st32.R.double())), cfg)
    # an f64 SchurQ, one on another card
    assert not tr.graph_route(_on_card(sq), card32, cfg)
    assert not tr.graph_route(_on_card(s32, 1), card32, cfg)
    # the two-float forms, whatever their payload
    for q in (sq.edge_f32(), sq.two_float(),
              cast_qop(sq.edge_f32(), torch.float32)):
        assert not tr.graph_route(_on_card(q), card32, cfg)
    # a sharded SchurQ (built on the host)
    sharded = split_schurq(s32, [torch.device("cpu")] * 2,
                           torch.device("cpu"))
    assert not tr.graph_route(_on_card(sharded), card32, cfg)
    # the operator, the carry, or both on the host
    assert not tr.graph_route(s32, st32, cfg)
    assert not tr.graph_route(s32, card32, cfg)
    assert not tr.graph_route(_on_card(s32), st32, cfg)


class _HostGraph:
    """A graph's replay on the host: the captured segment run again, its
    new outputs copied into the capture's buffers (a graph writes where its
    capture allocated), and nothing counted in Python."""

    def __init__(self, phase, fn):
        self.phase, self.fn = phase, fn

    def replay(self):
        before = timer.counts()
        keep = {k: getattr(self.phase, k) for k in ("grad", "args", "out")}
        self.fn()
        for k, old in keep.items():
            new = getattr(self.phase, k)
            if old is not None and new is not old:
                for a, b in zip(old, new):
                    a.copy_(b)
                setattr(self.phase, k, old)
        timer.set_counts(before)


def _host_graphs(monkeypatch, phase):
    """``phase`` capturing through :class:`_HostGraph`: a warm-up run and
    a capture run, each of which counts as the card's do."""
    def graph(self, name, fn):
        fn()
        warm = timer.counts()
        fn()
        return _HostGraph(self, fn), gs._moved(warm, timer.counts())

    monkeypatch.setattr(PhaseGraphs, "_graph", graph)
    phase.capture = True


def _phase_of(variant, o, monkeypatch):
    """The f32 phase of :func:`_phase` on the small scene's ``DenseQ``
    (``dense``, ``split``: the split variant at a host size, where no n
    passes the dense gate) or on the window scene's f32 ``SchurQ``."""
    if variant == "split":
        monkeypatch.setattr(ft, "DENSE_MAX_N", 0)
    if variant.startswith("schurq"):
        return _first_state(cast_qop(_window("cpu"), torch.float32), o, 1)
    return _phase(SMALL, o, "cpu")


@pytest.mark.parametrize("variant,o", [
    ("dense", 3), ("dense", 4), ("split", 3), ("split", 4), ("schurq", 3),
    ("schurq", 4), ("schurq-replayed", 3)])
def test_segments_are_the_eager_step(variant, o, monkeypatch):
    """A scene's whole f32 phase through the one ``_outer_step``: the graph
    provider's segments, run eagerly on its static buffers or (``-replayed``)
    replayed by the host stand-in, give the eager provider's bits step by
    step and move every count as the eager steps do, but the replays'."""
    _routed_to_fused(monkeypatch)
    q32, st0, lam, gradtol, delta_bar, cfg = _phase_of(variant, o,
                                                       monkeypatch)
    a, b = st0, st0
    eager = _eager_segments(q32, lam, cfg)
    start, products, replayed = timer.counts(), 0, 0
    with contextlib.closing(PhaseGraphs(q32, st0, lam, cfg)) as phase:
        if variant.endswith("replayed"):
            _host_graphs(monkeypatch, phase)
        else:
            assert not phase.capture
        while not a.done and a.k < 100:
            c0 = timer.counts()
            a = tr._outer_step(eager, a, gradtol, delta_bar)
            c1 = timer.counts()
            b = tr._outer_step(phase, b, gradtol, delta_bar)
            c2 = timer.counts()
            _assert_same(a, b)
            made = gs._moved(c1, c2)
            replayed += made.pop(timer.applies_replayed, 0)
            made.pop(timer.graph_replays, None)
            assert made == gs._moved(c0, c1), a.k
            products += sum(made.get(c, 0) for c in timer.PRODUCTS)
        graphs = {k: g.products for k, g in phase.graphs.items()}
    assert a.done and a.k > 5 and a.total_inner > a.k
    assert b.R is not st0.R      # the phase stepped on its own buffers
    # the host takes the plain twins: no launch counted
    end = timer.counts()
    assert all(end[k] == start[k] for k in timer.LAUNCHERS)
    if variant == "schurq-replayed":
        # a product a replay of the product and the end segments, and
        # every product of the phase's steps replayed
        assert graphs == dict(start=0, product=1, end=1, accept=0)
        assert replayed == products > a.total_inner
    else:
        assert not graphs and replayed == 0
        assert (products > a.total_inner) == variant.startswith("schurq")


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


def _profiled(fn):
    """``fn()`` under the profiler: ``(its result, the card's kernel names,
    the host events' names)``.  The window opens with spin kernels, since
    the profiler may drop a window's first device events late in a
    process."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(256):
            torch.cuda._sleep(1)
        out = fn()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    return (out, [e.name().replace(" ", "") for e in events
                  if e.device_type() == cuda],
            [e.name() for e in events if e.device_type() != cuda])


def _tcg_events(fn):
    """``fn()`` under the profiler: the ``tcg_step`` and ``tcg_step_dense``
    kernels it recorded, and the wrappers' counts of the same."""
    before = (ft.tcg_step.launches, ft.tcg_step_dense.launches)
    out, names, _ = _profiled(fn)
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


def _key(launcher):
    """A kernel launcher's key in ``utils.timer.counts``."""
    return launcher.__module__, launcher.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("o", [3, 4])
def test_graph_route_on_schurq_is_the_eager_step_on_card(o, cuda_device):
    """The window scene's f32 phase on the captured route: the eager
    route's bits and every count of it, the replays' own counts aside, and
    the profiler's kernels against the wrappers' counts.  The profiled run
    follows a first graphed run, so that no segment's first capture in the
    process falls in the profiler's window: its eager warm-up runs the
    segment's kernels, which the solve did not ask for and no count
    holds."""
    q32, st0, lam, gradtol, delta_bar, cfg = _first_state(
        cast_qop(_window(cuda_device), torch.float32), o, 1)
    assert tr.graph_route(q32, st0, cfg)

    def graphed():
        return tr._run_chunk(q32, st0, lam, gradtol, delta_bar, cfg, 100)

    c0 = timer.counts()
    eager = _eager(q32, st0, lam, gradtol, delta_bar, cfg)
    c1 = timer.counts()
    _assert_same(eager, graphed())
    c2 = timer.counts()
    again, kern, host = _profiled(graphed)
    c3 = timer.counts()
    _assert_same(eager, again)
    assert eager.k > 5 and eager.total_inner > eager.k
    made = gs._moved(c2, c3)
    assert gs._moved(c1, c2) == made
    replayed = made.pop(timer.applies_replayed)
    replays = made.pop(timer.graph_replays)
    # the eager route's counts: host reads, launches and products, every
    # product fused; the replayed ones counted
    assert made == gs._moved(c0, c1)
    fused = made[_key(schurq_product)]
    assert made[timer.applies_f32] == made[timer.applies_fused] == fused > 0
    assert timer.applies_f64 not in made and timer.applies_tf not in made
    assert 0 < replayed <= fused
    # the profiler saw every launch the wrappers counted (o columns fit one
    # launch of the fused product's kernels), and no segment sum ran,
    # replayed or not
    launched = made[_key(ft.tcg_step)]
    assert sum("tcg_step_kernel" in nm for nm in kern) == launched > 0
    assert sum("schurq_frame_out" in nm for nm in kern) == fused
    assert not any("segsum" in nm for nm in kern)
    assert _key(ss.sorted_segment_sum) not in made
    # a product replay before each split launch, in the product's span
    assert replays >= 2 * again.k + launched
    assert host.count(APPLY_SPAN) >= launched
    assert again.R.is_cuda and again.R is not st0.R
