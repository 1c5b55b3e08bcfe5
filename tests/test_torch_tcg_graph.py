"""The f64 tCG on device scalars (``trust_region._tcg_open`` and
``_tcg_body``) replayed as CUDA graphs by ``graph_step.InnerGraphs``,
against the same loop run eagerly, one iteration a read
(``trust_region._inner_tcg``).

A replay may run iterations past the loop's stop, which keep every carried
value, so both must give the same bits: the step, its Hessian product, the
end reason and the iteration count.  On the CPU the provider's segments
run eagerly (the tests' mirror of the route): each end reason on a dense
operator and on a window scene's ``SchurQ``, each with its f32 cast as the
tCG's product, at ``FLAG_EVERY`` iterations a replay and at one; a host
stand-in for a graph, which holds the counting rule; and a whole solve at
``xm2_solve``'s settings through the mirror.  On the card the graphed
chunk runs against the eager one, with every count stated.
``test_torch_tcg_graph_parity.py`` holds the provider to the JAX
package's loop.

This file imports neither JAX nor ``xmtpu``, so it also runs on the machine
with the card:

    python -m pytest tests/test_torch_tcg_graph.py --noconftest -q
"""

import contextlib
import copy
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from xmtpu_torch.assembly.creatematrix import create_matrix_arrays
from xmtpu_torch.ops import fused_tcg as ft
from xmtpu_torch.ops import manifold as mf
from xmtpu_torch.ops.qop import DenseQ, cast_qop
from xmtpu_torch.ops.schurq import SchurQ, schurq_product
from xmtpu_torch.parallel.sharded import split_dense, split_schurq
from xmtpu_torch.pipeline.synthetic import make_scene, make_scene_window
from xmtpu_torch.solver import graph_step as gs
from xmtpu_torch.solver import trust_region as tr
from xmtpu_torch.solver.graph_step import InnerGraphs
from xmtpu_torch.solver.staircase import solve_arrays
from xmtpu_torch.utils import timer

DENSE = dict(n_cameras=24, n_points=150, obs_per_camera=20, noise=1e-2,
             seed=0)
WINDOW = dict(n_cameras=30, n_points=300, obs_per_camera=20, noise=1e-3,
              long_range=4, seed=0)
# the counts that only the replays move
REPLAY_ONLY = (timer.graph_replays, timer.applies_replayed,
               timer.inner_replayed, timer.inner_masked)


@functools.lru_cache(maxsize=None)
def _operator(kind: str, device: str = "cpu"):
    """The float64 operator of a small scene: ``dense`` (``DenseQ``) or
    ``schurq`` (a window scene's ``SchurQ``)."""
    if kind == "dense":
        sc = make_scene(**DENSE)
        C, _ = create_matrix_arrays(sc.weights, sc.edges, sc.landmarks,
                                    precision="f64", device=device)
        return DenseQ(C)
    sc = make_scene_window(**WINDOW)
    return SchurQ.build(sc.weights, sc.edges, sc.landmarks, device=device)


def _inner_product(q32, dtype=torch.float64):
    """The f64 ladder's tCG product on ``q32``, as ``_run_chunk`` makes
    it: the cast to f32, the product, the cast back."""
    def qmul(Y):
        return q32.apply(Y.to(torch.float32)).to(dtype)
    return qmul


def _drawn(n, o, seed=1):
    """Float64 frames and scales at rank ``o`` drawn around the identity,
    on the host."""
    g = torch.Generator().manual_seed(seed)
    R0 = mf.mgs_rows(mf.identity_frames(n, o)
                     + 0.3 * torch.randn((n, 3, o), generator=g,
                                         dtype=torch.float64))
    s0 = 1.0 + 0.3 * torch.rand((n,), generator=g, dtype=torch.float64)
    s0[0] = 1.0
    return R0, s0


def _start(q, o, lam, steps):
    """A float64 point at rank ``o``: :func:`_drawn`, then ``steps`` outer
    steps of the host trust region."""
    R0, s0 = _drawn(q.dim // 3, o)
    if not steps:
        return R0, s0
    res = tr.trust_region_solve(q, R0, s0, lam, gradtol=1e-14,
                                cfg=tr.TRConfig(max_outer=steps,
                                                chunk=steps), device="cpu")
    return res.R, res.s_ex


def _problem(kind, o, lam, steps, delta, **cfg):
    """One tCG solve's inputs: ``(q32, qmul, Cdiag, st, grad, gradnorm,
    lam, cfg)``, the state at radius ``delta``."""
    q = _operator(kind)
    q32 = cast_qop(q, torch.float32)
    cfg = tr.TRConfig(**cfg)
    lam = np.float64(lam)
    R, s_ex = _start(q, o, lam, steps)
    st = tr._init_state(q, R, s_ex, lam, np.float64(10.0), cfg)
    st = st._replace(delta=np.float64(delta))
    grad = tr._step_start(q.apply, st.R, st.s_ex, st.QsR, float(lam))
    (gradnorm,) = tr._fetch(grad[5], dt=np.float64)
    return (q32, _inner_product(q32), q.diag_blocks(), st, grad, gradnorm,
            lam, cfg)


def _eager(q32, qmul, Cdiag, st, grad, gradnorm, lam, cfg):
    """The loop run eagerly, one iteration a read."""
    minv = tr._build_minv(Cdiag, st.s_ex, lam)
    return tr._inner_tcg(qmul, st.R, st.s_ex, *grad[:5], gradnorm,
                         st.delta, lam, cfg, minv=minv)


def _device(q32, qmul, Cdiag, st, grad, gradnorm, lam, cfg):
    """The route's solve, its vectors copied out of the carry."""
    with contextlib.closing(InnerGraphs(q32, qmul, Cdiag, st, lam,
                                        cfg)) as inner:
        out = inner.solve(st, grad, gradnorm)
    return tuple(t.clone() for t in out[:4]) + out[4:]


def _assert_bits(a, b):
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    assert a[4:] == b[4:]


def _fake_cuda(t, index=0):
    """A stand-in with a tensor's dtype on a CUDA device, for the route
    rule alone."""
    return SimpleNamespace(dtype=t.dtype, device=torch.device("cuda", index))


def _on_card(q, index=0):
    """``q`` with its ``inv_q3`` (what the implicit operators' route rule
    reads) on a card."""
    q = copy.copy(q)
    q.inv_q3 = _fake_cuda(q.inv_q3, index)
    return q


# ---------------------------------------------------------------- the CPU --

def test_tcg_route_rule():
    q = _operator("dense")
    st = tr._init_state(q, mf.identity_frames(q.dim // 3, 3),
                        torch.ones(q.dim // 3, dtype=torch.float64), 0.0,
                        10.0, tr.TRConfig())
    cfg = tr.TRConfig(inner_f32=True)
    card = st._replace(R=_fake_cuda(st.R))
    q32 = DenseQ(_fake_cuda(q.C.float()))
    # an f64 carry on the card, its products on an f32 DenseQ there
    assert tr.tcg_graph_route(q32, card, cfg)
    # every CPU run: the carry, the operator, or both on the host
    assert not tr.tcg_graph_route(cast_qop(q, torch.float32), st, cfg)
    assert not tr.tcg_graph_route(q32, st, cfg)
    assert not tr.tcg_graph_route(cast_qop(q, torch.float32), card, cfg)
    # no preconditioner; an f32 carry (the fused kernels' route)
    assert not tr.tcg_graph_route(q32, card,
                                  tr.TRConfig(precondition=False))
    assert not tr.tcg_graph_route(
        q32, st._replace(R=_fake_cuda(st.R.float())), cfg)
    # the f64 operator itself as the product; f32 on another card
    assert not tr.tcg_graph_route(DenseQ(_fake_cuda(q.C)), card, cfg)
    assert not tr.tcg_graph_route(DenseQ(_fake_cuda(q.C.float(), 1)), card,
                                  cfg)
    # a sharded dense operator (built on the host)
    sharded = split_dense(q.C, [torch.device("cpu")] * 2,
                          torch.device("cpu")).cast(torch.float32)
    assert not tr.tcg_graph_route(sharded, card, cfg)
    # a whole f32 SchurQ on the card: the fused product's route
    sq = _operator("schurq")
    s32 = cast_qop(sq, torch.float32)
    assert tr.tcg_graph_route(_on_card(s32), card, cfg)
    assert not tr.tcg_graph_route(_on_card(s32, 1), card, cfg)
    assert not tr.tcg_graph_route(_on_card(sq), card, cfg)
    assert not tr.tcg_graph_route(s32, card, cfg)
    # the two-float forms, whatever their payload, and a sharded SchurQ
    for form in (sq.edge_f32(), sq.two_float(),
                 cast_qop(sq.edge_f32(), torch.float32),
                 split_schurq(s32, [torch.device("cpu")] * 2,
                              torch.device("cpu"))):
        assert not tr.tcg_graph_route(_on_card(form), card, cfg)


# (operator, rank, lam, host outer steps to the start, radius, config,
# the end reason the loop reaches)
CASES = [
    ("dense", 3, 0.0, 5, 1e6, {}, tr.ER_NEGCURV),
    ("dense", 3, 0.7, 10, 1e6, {}, tr.ER_NEGCURV),
    ("schurq", 3, 0.0, 5, 1e6, {}, tr.ER_NEGCURV),
    ("schurq", 4, 0.7, 10, 1e6, {}, tr.ER_NEGCURV),
    ("dense", 4, 0.7, 20, 1.0, {}, tr.ER_BOUNDARY),
    ("schurq", 4, 0.0, 20, 1.0, {}, tr.ER_BOUNDARY),
    ("schurq", 3, 0.7, 20, 0.1, {}, tr.ER_BOUNDARY),
    ("dense", 4, 0.0, 20, 1e6, {}, tr.ER_SUPERLINEAR),
    ("dense", 4, 0.7, 20, 1e6, {}, tr.ER_SUPERLINEAR),
    ("schurq", 3, 0.7, 20, 1e6, {}, tr.ER_SUPERLINEAR),
    ("schurq", 4, 0.0, 20, 1e6, {}, tr.ER_SUPERLINEAR),
    ("dense", 4, 0.7, 40, 1e6, {}, tr.ER_SMALL_RDOTR),
    ("schurq", 4, 0.0, 40, 1e6, {}, tr.ER_SMALL_RDOTR),
    ("dense", 3, 0.0, 0, 1e6, dict(rdotr_min=1e300), tr.ER_SMALL_RDOTR),
    ("dense", 3, 0.0, 20, 1e6, dict(max_inner=2), tr.ER_MAX_INNER),
    ("schurq", 4, 0.7, 20, 1e6, dict(max_inner=5), tr.ER_MAX_INNER),
]


@pytest.mark.parametrize("kind,o,lam,steps,delta,cfg,reason", CASES)
def test_loop_is_the_host_loop(kind, o, lam, steps, delta, cfg, reason,
                               monkeypatch):
    """The route's provider, its segments run on the host, against the
    eager loop ``_inner_tcg`` bit for bit, at ``FLAG_EVERY`` iterations a
    replay and at one: iterations past the stop keep every carried
    value."""
    prob = _problem(kind, o, lam, steps, delta, **cfg)
    host = _eager(*prob)
    assert host[4] == reason
    if reason == tr.ER_MAX_INNER:
        assert host[5] == prob[-1].max_inner
    for every in (ft.FLAG_EVERY, 1):
        monkeypatch.setattr(ft, "FLAG_EVERY", every)
        _assert_bits(host, _device(*prob))


class _HostGraph:
    """A graph's replay on the host: the captured segment run again, with
    nothing counted in Python (the segments write their static buffers)."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        before = timer.counts()
        self.fn()
        timer.set_counts(before)


def test_replays_count_as_captured(monkeypatch):
    """Through a host stand-in for a graph: the eager loop's bits, one read
    a replay and none inside a capture, every product a replay ran counted
    (the masked ones too) and replayed, the iterations split into replayed
    and masked."""
    capturing = []

    def graph(self, name, fn):
        capturing.append(name)
        fn()
        warm = timer.counts()
        fn()
        capturing.pop()
        return _HostGraph(fn), gs._moved(warm, timer.counts())

    read = ft._read_carry

    def checked_read(sc):
        assert not capturing
        return read(sc)

    monkeypatch.setattr(InnerGraphs, "_graph", graph)
    monkeypatch.setattr(ft, "_read_carry", checked_read)
    prob = _problem("schurq", 4, 0.7, 20, 1e6)
    host = _eager(*prob)
    inner = InnerGraphs(*prob[:4], prob[6], prob[7])
    inner.capture = True
    c0 = timer.counts()
    with contextlib.closing(inner):
        out = inner.solve(*prob[3:6])
        made = gs._moved(c0, timer.counts())
        _assert_bits(host, out)
        assert {k: g.products for k, g in inner.graphs.items()} == dict(
            open=0, loop=1)
    iters = host[5]
    loops = made[timer.host_reads]
    assert loops == -(-iters // ft.FLAG_EVERY) > 1
    # the preamble once, the one-iteration loop FLAG_EVERY times a read
    assert made[timer.graph_replays] == 1 + loops * ft.FLAG_EVERY
    assert made[timer.inner_replayed] == iters
    masked = made.get(timer.inner_masked, 0)
    assert masked == loops * ft.FLAG_EVERY - iters > 0
    assert (made[timer.applies_f32] == made[timer.applies_replayed]
            == iters + masked)


def _xm2_solve(q):
    """``solve_arrays`` at ``xm2_solve``'s settings on the window scene's
    operator: f64, the f32 tCG products, the two-float stage operator, lam
    the observations a camera."""
    sc = make_scene_window(**WINDOW)
    return solve_arrays(q, max_rank=5, tol=1e-1,
                        lam=len(sc.edges) / sc.N, verbose=False,
                        precision="f64", inner_f32=True, edge_tf=True,
                        device="cpu")


def test_solve_through_the_route_is_the_host_solve(monkeypatch):
    """A whole solve with the route forced through its host mirror: the
    eager loop's primal, iterates and counts, with fewer host reads."""
    q = _operator("schurq")
    a = _xm2_solve(q)

    def route(q32, st, cfg):
        return cfg.precondition and st.R.dtype == torch.float64

    monkeypatch.setattr(tr, "tcg_graph_route", route)
    b = _xm2_solve(q)
    assert a.certified and b.certified
    assert b.primal == a.primal and b.rank == a.rank
    assert np.array_equal(a.R, b.R) and np.array_equal(a.s_ex, b.s_ex)
    assert (b.outer_iters, b.total_inner) == (a.outer_iters, a.total_inner)
    for x, y in zip(a.stages, b.stages):
        assert (x["outer"], x["inner"]) == (y["outer"], y["inner"])
        # the route's one read every FLAG_EVERY iterations, where the
        # eager loop reads once an iteration; the host mirror replays
        # nothing
        assert y["host_reads"] < x["host_reads"]
        assert x["inner_replayed"] == y["inner_replayed"] == 0
        assert x["inner_masked"] == y["inner_masked"] == 0


# --------------------------------------------------------------- the card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have "
                    "no CPU mode")
    return torch.device("cuda")


def _key(launcher):
    """A kernel launcher's key in ``utils.timer.counts``."""
    return launcher.__module__, launcher.__name__


def _chunk_inputs(kind, device, o):
    """An f64 stage with its tCG products on an f32 operator, from a start
    drawn around the identity: ``schurq``, a window scene's as
    ``xm2_solve`` runs it (the two-float stage operator, the fused f32
    products, lam = |E|/N); ``dense``, a dense scene's as the mixed ladder
    polishes it (the f64 ``DenseQ``, f32 GEMM products, lam = 0)."""
    if kind == "dense":
        sc = make_scene(n_cameras=120, n_points=400, obs_per_camera=10,
                        noise=0.05, seed=1)
        C, _ = create_matrix_arrays(sc.weights, sc.edges, sc.landmarks,
                                    precision="f64", device=device)
        stage = DenseQ(C)
        q32 = cast_qop(stage, torch.float32)
        lam = np.float64(0.0)
        cfg = tr.TRConfig(inner_f32=True)
    else:
        sc = make_scene_window(**dict(WINDOW, n_cameras=48, n_points=600,
                                      obs_per_camera=30))
        sq = SchurQ.build(sc.weights, sc.edges, sc.landmarks, device=device)
        stage, q32 = sq.two_float(), cast_qop(sq, torch.float32)
        lam = np.float64(len(sc.edges) / sc.N)
        cfg = tr.TRConfig(inner_f32=True, stop_on_collapse=True)
    n = sc.N
    R0, s0 = _drawn(n, o)
    delta_bar = np.float64(np.sqrt(n * (3 * o - 6) + n - 1))
    st = tr._init_state(stage, R0.to(device), s0.to(device), lam,
                        delta_bar, cfg)
    return stage, q32, st, lam, np.float64(1e-3), delta_bar, cfg


def _profiled(fn):
    """``fn()`` under the profiler: its result and the card's kernel names.
    The window opens with spin kernels, since the profiler may drop a
    window's first device events late in a process."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(256):
            torch.cuda._sleep(1)
        out = fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return out, [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == cuda]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,o", [("schurq", 3), ("schurq", 4),
                                    ("dense", 3)])
def test_graphed_chunk_is_the_eager_chunk_on_card(kind, o, cuda_device,
                                                  monkeypatch):
    """An f64 stage's chunk with its tCG replayed, on a fused ``SchurQ``
    and on an f32 ``DenseQ``, against the same chunk on the eager loop: the
    same bits, and every count the eager chunk's but the host reads, the
    replays and the masked iterations' products, which are stated.  No
    host read falls inside a capture.  The profiled run follows a first
    graphed run, so that no segment's first capture in the process falls
    in the profiler's window."""
    stage, q32, st0, lam, gradtol, delta_bar, cfg = _chunk_inputs(
        kind, cuda_device, o)
    assert tr.tcg_graph_route(q32, st0, cfg)
    fetch, read = tr._fetch, ft._read_carry

    def outside(fn):
        def call(*args, **kwargs):
            assert not torch.cuda.is_current_stream_capturing()
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(tr, "_fetch", outside(fetch))
    monkeypatch.setattr(ft, "_read_carry", outside(read))

    def chunk():
        return tr._run_chunk(stage, st0, lam, gradtol, delta_bar, cfg, 100,
                             Q32=q32)

    # one fused product's counts
    c0 = timer.counts()
    q32.apply(torch.zeros((q32.dim, o), device=cuda_device))
    per_product = gs._moved(c0, timer.counts())
    assert per_product.get(timer.applies_fused, 0) == (kind == "schurq")

    with monkeypatch.context() as m:
        m.setattr(tr, "tcg_graph_route", lambda *a: False)
        c0 = timer.counts()
        eager = chunk()
        eager_made = gs._moved(c0, timer.counts())
    c1 = timer.counts()
    first = chunk()
    c2 = timer.counts()
    again, kern = _profiled(chunk)
    made = gs._moved(c2, timer.counts())
    for b in (first, again):
        for name in ("R", "s_ex", "QsR"):
            assert torch.equal(getattr(eager, name), getattr(b, name)), name
        for name in ("loss", "delta", "k", "total_inner", "gradnorm",
                     "done_reason", "shrink_count", "collapse_count"):
            assert getattr(eager, name) == getattr(b, name), name
    assert gs._moved(c1, c2) == made
    iters = again.total_inner - st0.total_inner
    assert eager.k > 5 and iters > eager.k
    # the iterations: every one replayed, the masked ones stated
    assert made.pop(timer.inner_replayed) == iters
    masked = made.pop(timer.inner_masked, 0)
    loops = (iters + masked) // ft.FLAG_EVERY
    assert loops * ft.FLAG_EVERY == iters + masked
    # a replay of the preamble every tCG, of the loop every iteration run
    solves = made.pop(timer.graph_replays) - loops * ft.FLAG_EVERY
    assert 0 < solves <= again.k
    # every loop's products replayed (DenseQ's products are not counted)
    assert made.pop(timer.applies_replayed, 0) == (
        loops * ft.FLAG_EVERY * per_product.get(timer.applies_f32, 0))
    # the eager tCG read once an iteration; the route once a loop
    reads = made.pop(timer.host_reads)
    assert eager_made.pop(timer.host_reads) - reads == iters - loops
    # every other count the eager chunk's, the masked products aside
    for k in set(made) | set(eager_made):
        extra = masked * per_product.get(k, 0)
        assert made.get(k, 0) - eager_made.get(k, 0) == extra, k
    assert not any(k in eager_made for k in REPLAY_ONLY)
    # the profiler saw every fused product the wrappers counted, the
    # masked ones included: the tCG's, as the outer ones are two-float
    if kind == "schurq":
        fused = made[_key(schurq_product)]
        assert sum("schurq_frame_out" in nm for nm in kern) == fused
        assert fused == made[timer.applies_fused] == iters + masked
