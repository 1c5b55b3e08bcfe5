"""XM^2: outlier-rejecting two-pass solve with adaptive scale regularization.

PyTorch counterpart of ``xmtpu/pipeline/xm2.py`` (see it for the reference
drivers' flow): first staircase solve with ``lam = |E| / N``, per-observation
residuals, drop the top decile, re-clean the view graph, a rank-3 probe with
``lam = 0`` that re-enables ``lam`` when the scales look degenerate, the final
staircase solve and recovery — in memory through
:func:`xmtpu_torch.solver.staircase.solve_arrays`.

``implicit="auto"`` picks the factored ``SchurQ`` operator when the dense
assembly would not fit (:func:`choose_implicit`); its stages run the
production policy (``inner_f32`` + ``edge_tf`` at loose tolerances), its
segment sums on the card through the CUDA kernel, its certificate and
recovery on the exact operator.

Tracing (``utils/timer.py``): ``xm.xm2`` spans the whole of
:func:`xm2_solve`, ``xm.xm2.host`` each of its host stages over the
observations (the two ``checklandmarks`` calls, the residuals with the
percentile cut); ``SchurQ.build`` opens ``xm.schurq.build``.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np

from xmtpu_torch._device import resolve_device
from xmtpu_torch.assembly.creatematrix import create_matrix_arrays
from xmtpu_torch.pipeline.graph import checklandmarks
from xmtpu_torch.pipeline.recover import recover_XM, recover_XM_implicit
from xmtpu_torch.solver.staircase import solve_arrays
from xmtpu_torch.utils.timer import span, spanned

HOST_SPAN = "xm.xm2.host"


class XM2Result(NamedTuple):
    R_real: np.ndarray    # (3, 3N) c2w rotation blocks
    s_real: np.ndarray    # (N,)
    p_est: np.ndarray     # (3, M)
    t_est: np.ndarray     # (3, N)
    edges: np.ndarray
    weights: np.ndarray
    landmarks: np.ndarray
    rgbs: np.ndarray
    indices_all: np.ndarray
    lam: float
    first_pass: tuple     # (R_real, s_real, p_est, t_est) before the cut
    # every SolveResult run, in order: pass 1, the rank-3 probe, pass 2
    results: tuple = ()
    # host-clock seconds of each recovery, in order: pass 1, pass 2
    recover_s: tuple = ()


def xm2_residuals(edges, weights, landmarks, R_real, s_real, t_est, p_est,
                  relative: bool = False) -> np.ndarray:
    """Per-observation weighted squared residual; ``relative=True`` divides
    the difference by the observation depth (learned monocular depth)."""
    src = edges[:, 0] - 1
    dst = edges[:, 1] - 1
    N = s_real.shape[0]
    Rb = R_real.reshape(3, N, 3).transpose(1, 0, 2)
    transformed = (s_real[src, None] * np.einsum("nij,nj->ni", Rb[src],
                                                 landmarks)
                   + t_est[:, src].T)
    diff = p_est[:, dst].T - transformed
    if relative:
        diff = diff / landmarks[:, 2][:, None]
    return weights * np.sum(diff**2, axis=1)


def choose_implicit(N: int, M: int, budget_bytes: int | None = None) -> bool:
    """Operator policy: dense C while its estimated assembly footprint
    ``(9N^2 + 2*3N(N+M)) * 8`` bytes fits the budget (default 4 GB,
    ``XMTPU_DENSE_BUDGET`` bytes overrides), factored SchurQ beyond."""
    if budget_bytes is None:
        budget_bytes = int(os.environ.get("XMTPU_DENSE_BUDGET", 4 << 30))
    est = (9 * N * N + 2 * 3 * N * (N + M)) * 8
    return est > budget_bytes


def _assemble_operator(weights, edges, landmarks, verbose, implicit,
                       precision: str = "f64", device=None):
    """Build the cost operator once for a probe + final solve.  Returns
    ``(op, Abar, implicit)``; SchurQ stays f64 (its factors feed the matvec
    certificate), the dense assembly follows ``precision``."""
    dev = resolve_device(device)
    if implicit == "auto":
        N = int(np.asarray(edges)[:, 0].max())
        M = int(np.asarray(edges)[:, 1].max())
        implicit = choose_implicit(N, M)
        if verbose:
            print(f"[xm2] operator: "
                  f"{'SchurQ (implicit)' if implicit else 'dense C'}")
    if implicit:
        from xmtpu_torch.ops.schurq import SchurQ

        return SchurQ.build(weights, edges, landmarks, device=dev), None, True
    from xmtpu_torch.ops.qop import DenseQ

    C, Abar = create_matrix_arrays(weights, edges, landmarks,
                                   precision=precision, device=dev)
    # a full-f64 assembly is structurally PSD (the certificate's Delta-bound
    # shortcut); the mixed assembly's rounding exceeds the acceptance bound
    return DenseQ(C, psd_hint=(precision == "f64")), Abar, False


def _solve_recover(op, Abar, implicit, max_rank, tol, lam, max_time, verbose,
                   precision, rank3_probe=False, device=None, walls=None):
    """``(SolveResult, (R_real, s_real, p_est, t_est))``, the recovery None
    for the rank-3 probe; ``walls``, a list where given, gets the
    recovery's host-clock seconds."""
    fast = {}
    if implicit:
        # production policy: f32 tCG Hessian applies and fully two-float
        # outer-iteration applies at the pipeline's loose tolerances; the
        # certificate, the final primal and the recovery on the exact
        # operator
        inner_f32 = tol >= 1e-3
        fast = dict(inner_f32=inner_f32, edge_tf=inner_f32)
    if rank3_probe:
        return solve_arrays(op, 3, tol, lam, max_time, rank3_only=True,
                            verbose=verbose, precision=precision,
                            device=device, **fast), None
    res = solve_arrays(op, max_rank, tol, lam, max_time, verbose=verbose,
                       precision=precision, device=device, **fast)
    t0 = time.perf_counter()
    if implicit:
        rec = recover_XM_implicit(op, res.R, res.s_ex, lam, verbose=verbose)
    else:
        rec = recover_XM(op, res.R, res.s_ex, Abar, lam, verbose=verbose)
    if walls is not None:
        walls.append(time.perf_counter() - t0)
    return res, rec


@spanned("xm.xm2")
def xm2_solve(edges, weights, landmarks, rgbs, N, M,
              max_rank: int = 5, tol: float = 1e-1, max_time: float = 1000.0,
              relative: bool = False, percentile: float = 90.0,
              verbose: bool = True, implicit="auto",
              precision: str = "f64", timer=None, device=None) -> XM2Result:
    """Full XM^2 pipeline on a cleaned-or-raw observation set (the
    reference's arguments, plus ``device``: None = the CUDA card, ``"cpu"``
    for the host).  ``timer``: an optional ``PhaseTimer`` the caller reads
    back; by default a fresh one reported at ``verbose``.  The result holds
    every ``SolveResult`` run (``results``: pass 1, the probe, pass 2) and
    the two recoveries' host-clock seconds (``recover_s``)."""
    from xmtpu_torch.utils.timer import PhaseTimer

    dev = resolve_device(device)
    timer = timer if timer is not None else PhaseTimer()
    results, walls = [], []
    with timer.phase("clean1"), span(HOST_SPAN):
        edges, landmarks, weights, rgbs, indices_all = checklandmarks(
            edges, landmarks, weights, rgbs, N, M)

    # ---- pass 1 ----
    lam = edges.shape[0] / int(edges[:, 0].max())
    with timer.phase("pass1_assemble"):
        op1, Abar1, impl1 = _assemble_operator(weights, edges, landmarks,
                                               verbose, implicit, precision,
                                               dev)
    with timer.phase("pass1_solve_recover"):
        res, rec = _solve_recover(op1, Abar1, impl1, max_rank, tol, lam,
                                  max_time, verbose, precision, device=dev,
                                  walls=walls)
    results.append(res)
    del op1, Abar1
    R_real, s_real, p_est, t_est = rec
    first_pass = (R_real, s_real, p_est, t_est)

    # ---- residual cut ----
    with span(HOST_SPAN):
        with timer.phase("residuals"):
            error = xm2_residuals(edges, weights, landmarks, R_real, s_real,
                                  t_est, p_est, relative=relative)
        if verbose:
            print("sum of error: ", float(np.sum(error)))
        keep = error <= np.percentile(error, percentile)
        edges, weights, rgbs, landmarks = (edges[keep], weights[keep],
                                           rgbs[keep], landmarks[keep])

    # ---- re-clean + pass 2 ----
    N2 = s_real.shape[0]
    M2 = p_est.shape[1]
    with timer.phase("clean2"), span(HOST_SPAN):
        edges, landmarks, weights, rgbs, indices = checklandmarks(
            edges, landmarks, weights, rgbs, N2, M2)
    live = indices_all > -1
    indices_all[live] = indices[indices_all[live]]

    # rank-3 probe with lam = 0, then adaptive regularization; one operator
    # for the probe and the final solve (same observation set)
    lam = 0.0
    with timer.phase("pass2_assemble"):
        op2, Abar2, impl2 = _assemble_operator(weights, edges, landmarks,
                                               verbose, implicit, precision,
                                               dev)
    with timer.phase("pass2_probe"):
        probe, _ = _solve_recover(op2, Abar2, impl2, 3, tol, lam, max_time,
                                  verbose, precision, rank3_probe=True,
                                  device=dev)
    results.append(probe)
    s = probe.s_ex
    s_avg, s_std = np.mean(s[1:]), np.std(s[1:])
    if np.abs(s_avg - 1) > 2 * s_std or np.sum(s < 0.1) > 10:
        if verbose:
            print("s is too small, run again")
        lam = edges.shape[0] / int(edges[:, 0].max())
    elif verbose:
        print("s is good")
    with timer.phase("pass2_solve_recover"):
        res, rec = _solve_recover(op2, Abar2, impl2, max_rank, tol, lam,
                                  max_time, verbose, precision, device=dev,
                                  walls=walls)
    results.append(res)
    R_real, s_real, p_est, t_est = rec
    if verbose:
        print("[xm2 phases]\n" + timer.report())

    return XM2Result(R_real, s_real, p_est, t_est, edges, weights, landmarks,
                     rgbs, indices_all, lam, first_pass, tuple(results),
                     tuple(walls))
