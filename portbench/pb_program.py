"""The system under test, driven through its public solve path.

Everything the benchmark takes from ``xmtpu_torch`` is here: the operator
built in set-up (the dense assembly ``create_matrix_arrays`` into a
``DenseQ``, or ``SchurQ.build``), one solution (``solve_arrays``, then
``recover_XM`` or ``recover_XM_implicit``), the kernels' build, and
counting wrappers around the kernel launchers, put where their callers look
them up, for the per-layer readers of a traced run.  A route
(``routes/<name>.py``) serves its requests from these pieces, and from the
program's own entry points where it needs others.
"""

from __future__ import annotations

import functools
import time
import traceback
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

import xmtpu_torch  # noqa: F401  (switches TF32 off, as the program runs)
from pb_judge import Judged, Output
from xmtpu_torch import _build
from xmtpu_torch.assembly.creatematrix import create_matrix_arrays
from xmtpu_torch.ops import fused_tcg, schurq, segsum
from xmtpu_torch.ops.qop import DenseQ
from xmtpu_torch.pipeline.recover import recover_XM, recover_XM_implicit
from xmtpu_torch.pipeline.xm2 import choose_implicit
from xmtpu_torch.solver.staircase import solve_arrays


def build_kernels() -> dict:
    """Builds what is not built yet and loads both kernel libraries."""
    report = _build.build_all()
    for name in ("fused_tcg", "segsum"):
        _build.load(name)
    return report


class Operator(NamedTuple):
    op: object            # DenseQ or SchurQ
    Abar: object          # the dense recovery operator, or None
    implicit: bool


def build_operator(scene, config: dict, device) -> Operator:
    kind = config["operator"]
    if choose_implicit(scene.N, scene.M) != (kind == "schurq"):
        raise ValueError(f"the port's operator policy does not pick "
                         f"{kind} at N={scene.N}, M={scene.M}")
    if kind == "schurq":
        op = schurq.SchurQ.build(scene.weights, scene.edges, scene.landmarks,
                                 device=device)
        return Operator(op, None, True)
    prec = config["assembly_precision"]
    C, Abar = create_matrix_arrays(scene.weights, scene.edges,
                                   scene.landmarks, precision=prec,
                                   device=device)
    return Operator(DenseQ(C, psd_hint=(prec == "f64")), Abar, False)


class Solution(NamedTuple):
    """One served request: its wall and recovery seconds (host clock),
    every ``SolveResult`` it ran, in order, the outputs the judge reads
    (``pb_judge.Judged``), and the traceback of a request that raised."""

    scene: int
    wall_s: float
    recover_s: float
    results: tuple
    outputs: tuple
    error: str

    @property
    def result(self):
        """The request's last ``SolveResult``, or None when it ran none."""
        return self.results[-1] if self.results else None


def solve_one(k: int, operator: Operator, config: dict,
              device) -> Solution:
    """One certified solution of scene ``k``: the staircase, then recovery,
    timed on the host's clock; both end with their outputs on the host.
    Its one output is judged on the scene's own observations."""
    t0 = time.perf_counter()
    try:
        res = solve_arrays(operator.op, verbose=False, device=device,
                           **config["solve"])
        t1 = time.perf_counter()
        lam = config["solve"].get("lam", 0.0)
        if operator.implicit:
            rec = recover_XM_implicit(operator.op, res.R, res.s_ex, lam,
                                      verbose=False)
        else:
            rec = recover_XM(operator.op, res.R, res.s_ex, operator.Abar, lam,
                             verbose=False)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        out = Output(k, res.R, res.s_ex, float(res.primal),
                     bool(res.certified), *rec)
        return Solution(k, t2 - t0, t2 - t1, (res,),
                        (Judged(out, None, float(lam)),), "")
    except Exception:  # a solution that raises is counted as failed
        return Solution(k, time.perf_counter() - t0, 0.0, (), (),
                        traceback.format_exc())


class Launches:
    """Counting wrappers around the kernel launchers, installed where their
    callers look them up (``ops/schurq.py`` imports ``sorted_segment_sum``
    by name) and removed by :meth:`close`.

    ``tcg``: ``(dense, n, o) -> [launches, iterations]``, the iterations
    being those the fused loop reports it ran (a launch after the carry is
    done returns at once); ``segsum``: ``(rows, S, D, itemsize, index
    words) -> launches``."""

    def __init__(self):
        self.tcg = {}
        self.segsum = Counter()
        self._saved = []
        self._patch(fused_tcg, "tcg_step", self._step(False))
        self._patch(fused_tcg, "tcg_step_dense", self._step(True))
        self._patch(fused_tcg, "inner_tcg_fused", self._loop())
        wrapped = self._segsum(segsum.sorted_segment_sum)
        self._patch(segsum, "sorted_segment_sum", wrapped)
        self._patch(schurq, "sorted_segment_sum", wrapped)

    def _patch(self, mod, name, fn):
        self._saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def close(self):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []

    def _entry(self, dense, n, o):
        return self.tcg.setdefault((dense, n, o), [0, 0])

    def _step(self, dense):
        inner = getattr(fused_tcg, "tcg_step_dense" if dense else "tcg_step")

        # the launchers count themselves through their module's name, which
        # is now this wrapper's: it carries their attributes
        @functools.wraps(inner)
        def step(*args, **kw):
            Rt = args[1] if dense else args[0]
            if Rt.is_cuda:
                self._entry(dense, Rt.shape[1], Rt.shape[0] // 3)[0] += 1
            return inner(*args, **kw)
        return step

    def _loop(self):
        inner = fused_tcg.inner_tcg_fused

        @functools.wraps(inner)
        def loop(qmul, R, *args):
            n, _, o = R.shape
            before = self._entry(True, n, o)[0]
            out = inner(qmul, R, *args)
            dense = self._entry(True, n, o)[0] > before
            self._entry(dense, n, o)[1] += int(out[5])
            return out
        return loop

    def _segsum(self, inner):
        @functools.wraps(inner)
        def seg(vals, seg_ids, num_segments, band=0, offsets=None):
            if vals.is_cuda:
                plan = getattr(offsets, "csr_plan", None)
                E, D = vals.shape
                longs = (plan.n_long if plan is not None and plan.n_long
                         and D <= segsum.LONG_MAX_D else 0)
                self.segsum[(E, num_segments, D, vals.element_size(),
                             num_segments + 1 + 3 * longs)] += 1
            return inner(vals, seg_ids, num_segments, band, offsets)
        return seg


def probe_applies(operator: Operator, X: torch.Tensor) -> np.ndarray:
    """The operator's product with the probe block ``X``, on the host."""
    return operator.op.apply(X).cpu().numpy()
