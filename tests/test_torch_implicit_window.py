"""The ``ladybug1723.certify`` cell's route on the host: a window scene
through ``SchurQ`` at the cell's solve settings, judged by the benchmark's
plain reference; the mixed ladder's f32 phase ended at a non-finite
reading; and the implicit operator's span and counters.

The code under test imports no JAX: the judge is ``portbench/pb_reference.py``
and ``pb_judge.py`` (plain PyTorch), the scenes the port's own generator.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from xmtpu_torch.assembly.creatematrix import create_matrix_arrays
from xmtpu_torch.ops import qop as tqop
from xmtpu_torch.ops.qop import QOperator
from xmtpu_torch.ops.schurq import APPLY_SPAN, SchurQ
from xmtpu_torch.pipeline.recover import recover_XM_implicit
from xmtpu_torch.pipeline.synthetic import make_scene, make_scene_window
from xmtpu_torch.solver import trust_region as tr
from xmtpu_torch.solver.staircase import solve_arrays
from xmtpu_torch.utils import timer

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "portbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import pb_judge  # noqa: E402
import pb_reference  # noqa: E402

CPU = torch.device("cpu")
with open(os.path.join(BENCH, "configs", "ladybug1723.json")) as _f:
    CONFIG = json.load(_f)
SOLVE = dict(CONFIG["solve"], verbose=False, device=CPU)
WINDOW = dict(n_cameras=48, n_points=600, obs_per_camera=30, noise=1e-3,
              long_range=4)
# seed 2 leaves rank 3 at a saddle: the staircase escapes and certifies at 4
NOISY = dict(n_cameras=30, n_points=100, obs_per_camera=10, noise=0.35,
             seed=2)
DENSE_MIXED = dict(max_rank=6, tol=1e-6, precision="mixed", inner_f32=True,
                   verbose=False, device=CPU)


def _window(seed):
    sc = make_scene_window(**WINDOW, seed=seed)
    return sc, SchurQ.build(sc.weights, sc.edges, sc.landmarks, device=CPU)


@pytest.fixture(scope="module")
def window():
    return _window(0)


@pytest.mark.parametrize("seed", [0, 1])
def test_the_cells_settings_certify_and_pass_the_judge(seed):
    sc, op = _window(seed)
    res = solve_arrays(op, **SOLVE)
    assert res.certified
    rec = recover_XM_implicit(op, res.R, res.s_ex, 0.0, verbose=False)
    out = pb_judge.Output(0, res.R, res.s_ex, float(res.primal), True, *rec)
    el = pb_reference.eliminate(sc.edges, sc.weights, sc.landmarks, sc.N,
                                sc.M, torch.float64, CPU)
    X = pb_judge.probe_block(3 * sc.N, 2**31 + seed, 0, CPU)
    applied = op.apply(X).numpy()
    limits = CONFIG["limits"]
    worst = pb_judge.judge_scene(el, X, applied, [out], limits, 2**31 + seed,
                                 0, CPU)
    correct, checks = pb_judge.verdict(worst, 0, limits)
    assert correct, checks
    assert set(worst) == set(pb_judge.CHECKS) - {"failed"}


class _Poisoned(QOperator):
    """An f32 operator whose products turn NaN after ``k`` of them."""

    def __init__(self, q, k):
        self.q, self.k, self.calls = q, k, 0

    @property
    def dim(self):
        return self.q.dim

    @property
    def device(self):
        return self.q.device

    def to(self, device):
        assert torch.device(device) == self.device
        return self

    def diag_blocks(self):
        return self.q.diag_blocks()

    def apply(self, Y):
        self.calls += 1
        out = self.q.apply(Y)
        return out if self.calls <= self.k else torch.full_like(out,
                                                                float("nan"))


def _poison_f32_casts(monkeypatch, k):
    """Every f32 cast ``solve_arrays`` makes turns NaN after ``k``
    products; records the states the non-finite check ends and the last
    state each f32 phase kept."""
    cast = tqop.cast_qop
    seen = {"ends": [], "kept": []}

    def poisoned(Q, dtype):
        q = cast(Q, dtype)
        return _Poisoned(q, k) if dtype == torch.float32 else q

    def nonfinite(st, *readings):
        end = real_nonfinite(st, *readings)
        if end is not None:
            seen["ends"].append((end, seen["kept"][-1] if seen["kept"]
                                 else None))
        return end

    def decide(st, *args):
        keep, nxt = real_decide(st, *args)
        if st.R.dtype == torch.float32:
            seen["kept"].append(nxt.R if keep else st.R)
        return keep, nxt

    real_nonfinite, real_decide = tr._nonfinite, tr._step_decide
    monkeypatch.setattr(tqop, "cast_qop", poisoned)
    monkeypatch.setattr(tr, "_nonfinite", nonfinite)
    monkeypatch.setattr(tr, "_step_decide", decide)
    return seen


@pytest.mark.parametrize("kind,k", [("implicit", 1), ("implicit", 40),
                                    ("dense", 40)])
def test_a_nonfinite_f32_phase_ends_at_its_last_finite_iterate(
        kind, k, window, monkeypatch):
    if kind == "implicit":
        # the cell's settings; the polish's inner products in f64, so that
        # only the f32 phase meets the poisoned operator
        sc, op = window
        kw = dict(SOLVE, inner_f32=False)
    else:
        sc = make_scene(**NOISY)
        op = create_matrix_arrays(sc.weights, sc.edges, sc.landmarks,
                                  device=CPU)[0]
        kw = dict(DENSE_MIXED, inner_f32=False)
    seen = _poison_f32_casts(monkeypatch, k)
    res = solve_arrays(op, **kw)
    assert res.certified
    # the poison persists: every rank's f32 phase ends at it, once
    assert [st["f32_nonfinite"] for st in res.stages] == [1] * len(res.stages)
    assert len(seen["ends"]) == len(res.stages)
    first, last_kept = seen["ends"][0]
    assert first.done and first.done_reason == tr.DONE_NONFINITE
    assert bool(torch.isfinite(first.R).all())
    assert bool(torch.isfinite(first.s_ex).all())
    if k > 1:
        # rank 3's phase took steps first: it ends where its last step left
        # it
        assert last_kept is not None and first.R is last_kept
    else:
        # the first step's tCG met the turned products: it ends at its start
        assert last_kept is None
    # the stage certifies at the f64 polish's primal, and the plain
    # reference certifies that point too
    assert res.stages[-1]["primal"] == res.primal
    el = pb_reference.eliminate(sc.edges, sc.weights, sc.landmarks, sc.N,
                                sc.M, torch.float64, CPU)
    S = pb_reference.scaled_factor(res.R, res.s_ex, torch.float64, CPU)
    limits = CONFIG["limits"]
    cert = pb_reference.certificate(el.C, S, limits["cert_bound"],
                                    torch.Generator().manual_seed(k))
    assert (cert.lam_min > -limits["cert_bound"]
            or cert.gap / cert.primal < limits["cert_gap"])
    assert abs(res.primal - cert.primal) / cert.primal < 1e-9


def test_a_dense_mixed_solve_meets_no_nonfinite_reading():
    sc = make_scene(**NOISY)
    C = create_matrix_arrays(sc.weights, sc.edges, sc.landmarks,
                             device=CPU)[0]
    before = timer.f32_nonfinite.n
    res = solve_arrays(C, **DENSE_MIXED)
    assert res.certified and res.rank == 4
    assert [st["f32_nonfinite"] for st in res.stages] == [0, 0]
    assert timer.f32_nonfinite.n == before
    # dense ranks apply no implicit operator
    for st in res.stages:
        assert st["applies_f64"] == st["applies_tf"] == st["applies_f32"] == 0


def test_nonfinite_readings_end_only_an_f32_phase(window):
    sc, op = window
    R = torch.zeros((op.n_cameras, 3, 3))
    st = tr._init_state(op.cast(torch.float32), R + torch.eye(3),
                        torch.ones(op.n_cameras), np.float32(0.0),
                        np.float32(10.0), tr.TRConfig())
    before = timer.f32_nonfinite.n
    assert tr._nonfinite(st, np.float32(1.0), np.float32(-2.0)) is None
    for bad in (np.float32(np.nan), np.float32(np.inf)):
        end = tr._nonfinite(st, np.float32(1.0), bad)
        assert end.done and end.done_reason == tr.DONE_NONFINITE
        assert end.R is st.R and end.k == st.k
    radius = tr._nonfinite(st._replace(delta=np.float32(np.nan)))
    assert radius.done_reason == tr.DONE_NONFINITE
    assert timer.f32_nonfinite.n == before + 3
    f64 = st._replace(R=st.R.double())
    assert tr._nonfinite(f64, np.float64(np.nan)) is None


def test_a_zero_weight_penalty_leaves_a_far_trial_finite():
    # a far trial scale: its (s^2 - 1)^2 is inf in f32, 0 * inf would be NaN
    n, o = 4, 3
    R = torch.eye(3).expand(n, 3, o).clone()
    s_ex = torch.ones(n)
    vs = torch.tensor([0.0, 30.0, 0.0])
    zero = torch.zeros_like(R)
    C = torch.eye(3 * n)

    def qmul(Y):
        return C @ Y

    out = tr._step_end(qmul, R, s_ex, zero, vs, zero, torch.zeros(n - 1),
                       zero, torch.zeros(n - 1), 0.0)
    assert bool(torch.isfinite(out[1])) and float(out[1]) > 1e20
    with_weight = tr._step_end(qmul, R, s_ex, zero, vs, zero,
                               torch.zeros(n - 1), zero, torch.zeros(n - 1),
                               1.0)
    assert not bool(torch.isfinite(with_weight[1]))


def _xm_events(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("name", "").startswith("xm.")]


def _inside(e, outer):
    return (outer["ts"] - 1e-3 <= e["ts"]
            and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"] + 1e-3)


def _parent(e, events):
    around = [o for o in events if o is not e and o["tid"] == e["tid"]
              and _inside(e, o)]
    return min(around, key=lambda o: o["dur"]) if around else None


@pytest.mark.parametrize("form", ["edge_tf", "edge_f32"])
def test_apply_span_and_counters(form, window, tmp_path):
    _, op = window
    kw = dict(SOLVE, edge_tf=form == "edge_tf", edge_f32=form == "edge_f32")
    counters = {k: getattr(timer, k) for k in ("applies_f64", "applies_tf",
                                                "applies_f32")}
    with timer.device_trace(str(tmp_path)) as path:
        before = {k: c.n for k, c in counters.items()}
        res = solve_arrays(op, **kw)
        grown = {k: c.n - before[k] for k, c in counters.items()}
        recover_XM_implicit(op, res.R, res.s_ex, 0.0, verbose=False)
        # recovery is a leaf: even a product inside it opens no span
        timer.spanned("xm.recover", leaf=True)(op.apply)(
            torch.ones((op.dim, 3), dtype=torch.float64))
    assert res.certified
    ev = _xm_events(path)
    applies = [e for e in ev if e["name"] == APPLY_SPAN]
    per_rank = {k: sum(st[k] for st in res.stages) for k in counters}
    # the solve's products: each counted on its rank, each in its span
    assert grown == per_rank
    assert len(applies) == sum(per_rank.values())
    assert per_rank["applies_f64"] > 0 and per_rank["applies_f32"] > 0
    if form == "edge_tf":
        assert per_rank["applies_tf"] > 0
    else:
        assert per_rank["applies_tf"] == 0
    # in the trust region's spans or the certificate's, but for the
    # staircase's own reads of the loss: each phase's start and the primal
    # re-read through the exact operator, three a rank
    parents = [_parent(e, ev)["name"] for e in applies]
    assert all(p.startswith("xm.tr.") or p in ("xm.cert", "xm.stage")
               for p in parents)
    assert 0 < parents.count("xm.stage") <= 3 * len(res.stages)
    assert parents.count("xm.tr.tcg") > parents.count("xm.stage")
    for e in ev:
        if e["name"] == "xm.recover":
            assert not any(_inside(a, e) for a in applies)
            assert not any(o is not e and _inside(o, e) for o in ev)
