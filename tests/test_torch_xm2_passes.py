"""``xm2_solve`` hands back every solve it ran and its recoveries' walls,
and names its stages in a profiler trace: ``xm.xm2`` around the call,
``xm.xm2.host`` around each host stage over the observations,
``xm.schurq.build`` around each implicit operator's build.  Host only."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from xmtpu_torch.ops.schurq import BUILD_SPAN, SchurQ
from xmtpu_torch.pipeline import xm2 as txm2
from xmtpu_torch.pipeline.recover import recover_XM, recover_XM_implicit
from xmtpu_torch.pipeline.synthetic import make_scene_window
from xmtpu_torch.solver.staircase import SolveResult
from xmtpu_torch.utils import timer

CPU = "cpu"
WINDOW = dict(n_cameras=40, n_points=160, obs_per_camera=12, noise=1e-3,
              long_range=4, seed=3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the solves here are many small products, which
    the suite's parallel workers would otherwise crowd off the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _outlied():
    """A small window scene with a thirtieth of its rows moved by N(0, 1) * 5,
    as ``examples/05_refine.py`` plants outliers."""
    sc = make_scene_window(**WINDOW)
    rng = np.random.default_rng(7)
    x = sc.landmarks.copy()
    bad = rng.choice(len(x), size=len(x) // 30, replace=False)
    x[bad] += rng.normal(size=(len(bad), 3)) * 5.0
    return sc, x


def _run(implicit, trace=False):
    sc, x = _outlied()
    args = (sc.edges, sc.weights, x, sc.rgbs, sc.N, sc.M)
    kw = dict(verbose=False, implicit=implicit, device=CPU)
    if not trace:
        return txm2.xm2_solve(*args, **kw), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = txm2.xm2_solve(*args, **kw)
    events = prof.profiler.kineto_results.events()
    return r, [e.name() for e in events if e.name().startswith("xm.")]


@pytest.fixture(scope="module")
def traced():
    """Each route's run under the profiler: ``{implicit: (result, the
    xm. spans' names)}``."""
    return {implicit: _run(implicit, trace=True) for implicit in (True, False)}


@pytest.mark.parametrize("implicit", [True, False])
def test_every_solve_and_both_recoveries_come_back(implicit, traced):
    r, _ = traced[implicit]
    assert len(r.results) == 3
    assert all(isinstance(x, SolveResult) for x in r.results)
    first, probe, last = r.results
    # the probe: one rank-3 stage, no certificate
    assert probe.rank == 3 and len(probe.stages) == 1
    assert not probe.certified and "cert_path" not in probe.stages[0]
    assert last.certified
    assert len(r.recover_s) == 2 and all(t > 0 for t in r.recover_s)

    # each recovery, made again from its solve on its pass's operator, is
    # the result's, bit for bit: pass 1's on the cleaned scene, pass 2's on
    # the kept set
    sc, x = _outlied()
    e1, x1, w1, _, _ = txm2.checklandmarks(sc.edges, x, sc.weights, sc.rgbs,
                                           sc.N, sc.M)
    passes = ((e1, w1, x1, len(e1) / int(e1[:, 0].max()), first,
               r.first_pass),
              (r.edges, r.weights, r.landmarks, r.lam, last,
               (r.R_real, r.s_real, r.p_est, r.t_est)))
    for edges, w, x, lam, res, want in passes:
        if implicit:
            op = SchurQ.build(w, edges, x, device=CPU)
            got = recover_XM_implicit(op, res.R, res.s_ex, lam, verbose=False)
        else:
            op, Abar, _ = txm2._assemble_operator(w, edges, x, False, False,
                                                  device=CPU)
            got = recover_XM(op, res.R, res.s_ex, Abar, lam, verbose=False)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_the_spans_open_under_a_profiler(traced):
    _, names = traced[True]
    assert names.count("xm.xm2") == 1
    # the two checklandmarks calls and the residual cut
    assert names.count(txm2.HOST_SPAN) == 3
    assert names.count(BUILD_SPAN) == 2
    assert names.count("xm.solve") == 3


def test_the_dense_route_builds_no_schurq(traced):
    _, names = traced[False]
    assert names.count("xm.xm2") == 1 and BUILD_SPAN not in names
    assert names.count(txm2.HOST_SPAN) == 3


def test_without_a_profiler_the_spans_are_the_shared_no_op(monkeypatch):
    for name in ("xm.xm2", txm2.HOST_SPAN, BUILD_SPAN):
        assert timer.span(name) is timer._OFF
    seen = []

    def spy(name):
        seen.append(timer.span(name))
        return seen[-1]

    monkeypatch.setattr(txm2, "span", spy)
    r, _ = _run(True)
    assert len(seen) == 3 and all(s is timer._OFF for s in seen)
    assert len(r.results) == 3
    with profile(activities=[ProfilerActivity.CPU]):
        assert timer.span(BUILD_SPAN) is not timer._OFF
