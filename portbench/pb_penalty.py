"""Plain reference of the scale-penalised problem: XM^2's passes.

Plain PyTorch in float64 on one device; it imports nothing of the program.
XM^2 solves its first pass with a penalty on the scales, ``lam = |E| / N``
(its second too where its probe's scales look degenerate):

    f(S) = tr(S^T C S) + lam sum_i (x_ii - 1)^2,

``C`` the reduced cost of ``pb_reference.eliminate`` and ``x_ii`` the
(3i, 3i) entry of ``X = S S^T`` (``s_i^2`` at a factor with orthonormal
frame rows).  The penalty is convex in X; its tangent at the factor's
``x_ii`` bounds it from below, which gives the certificate

    Z = C + diag(2 lam (x_ii - 1)) on the (3i, 3i) entries - A^*(y),
    dual = tr(L_0) + lam sum_i (1 - x_ii^2),

with ``A^*(y)`` the multiplier blocks ``L_i`` of ``pb_reference`` worked out
at the penalised gradient ``G = (C + diag(2 lam (x_ii - 1))) S``.

Departure from writing it out: :func:`certificate` calls
``pb_reference.certificate`` on ``C_lam = C + diag(2 lam (x_ii - 1))``.  That
gives this ``Z``, its ``lam_min`` and the multipliers exactly; its primal
``tr(S^T C_lam S)`` and dual ``tr(L_0)`` differ from the penalised ones by
``sum_i 2 lam (x_ii - 1) x_ii`` each, so the gap is the same, and the
primal and dual are put right here.  The rounding, translations and
landmarks do not depend on ``lam``: they are read as ``pb_judge`` reads
them.  At ``lam = 0`` every reading is ``pb_judge``'s.  A solve that is not
certified but stopped by its gradient tolerance (XM^2's rank-3 probe) is
judged by its primal and by its Riemannian gradient norm (:func:`gradnorm`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

import pb_judge
import pb_reference as ref

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def diagonal(S: torch.Tensor) -> torch.Tensor:
    """``x_ii``, the (3i, 3i) entries of ``X = S S^T``: (N,)."""
    n = S.shape[0] // 3
    return torch.sum(S.reshape(n, 3, -1)[:, 0, :] ** 2, dim=-1)


def shifted(C: torch.Tensor, S: torch.Tensor, lam: float) -> torch.Tensor:
    """``C_lam = C + diag(2 lam (x_ii - 1))`` on the (3i, 3i) entries (a
    new tensor)."""
    Cl = C.clone()
    d = Cl.diagonal()[::3]
    d += 2.0 * lam * (diagonal(S) - 1.0)
    return Cl


def objective(C: torch.Tensor, S: torch.Tensor, lam: float) -> float:
    """``f(S) = tr(S^T C S) + lam sum_i (x_ii - 1)^2``."""
    return float(torch.sum(S * (C @ S))
                 + lam * torch.sum((diagonal(S) - 1.0) ** 2))


def certificate(C: torch.Tensor, S: torch.Tensor, lam: float, bound: float,
                generator: torch.Generator) -> ref.Certificate:
    """The dual certificate of the penalised problem at the factor ``S``
    (3N, o): ``pb_reference.certificate`` on ``C_lam``, its primal and dual
    put right (the module's note)."""
    x = diagonal(S)
    cert = ref.certificate(shifted(C, S, lam), S, bound, generator)
    lin = float(torch.sum(2.0 * lam * (x - 1.0) * x))
    primal = cert.primal - lin + lam * float(torch.sum((x - 1.0) ** 2))
    dual = cert.dual + lam * float(torch.sum(1.0 - x ** 2))
    return cert._replace(primal=primal, dual=dual)


def penalty(S: torch.Tensor, lam: float) -> float:
    """``lam sum_i (x_ii - 1)^2`` in ``S``'s dtype."""
    return float(lam * torch.sum((diagonal(S) - 1.0) ** 2))


def gradnorm(C: torch.Tensor, R, s_ex, lam: float, device) -> float:
    """The norm of ``f``'s Riemannian gradient at the factor ``S = s R``,
    in XM's coordinates: each frame's block ``R_i`` (3, o) on the Stiefel
    manifold (orthonormal rows), each scale ``s_i`` (``s_0 = 1`` fixed),
    under the metric ``<a_R, b_R> + sum_i a_s b_s / s_i^2``, the one whose
    norm XM's trust region stops on.  With ``G = 2 C S`` (``df/dS``), the
    Euclidean gradient is ``g_R = s_i G_i``, ``g_s = <G_i, R_i> + 4 lam
    (s_i^2 - 1) s_i``; its tangent part ``g_R - sym(g_R R_i^T) R_i`` and
    ``s_i^2 g_s``; the squared norm ``sum ||g_R - sym(g_R R_i^T) R_i||^2 +
    sum_{i >= 1} s_i^2 g_s^2``."""
    f64 = torch.float64
    s = torch.as_tensor(s_ex, dtype=f64, device=device)
    n = s.shape[0]
    Rb = torch.as_tensor(R, dtype=f64, device=device).reshape(n, 3, -1)
    S = s[:, None, None] * Rb
    G = 2.0 * (C @ S.reshape(3 * n, -1)).reshape(S.shape)
    gR = s[:, None, None] * G
    gs = (torch.einsum("nao,nao->n", G, Rb)[1:]
          + 4.0 * lam * (s[1:] ** 2 - 1.0) * s[1:])
    M = gR @ Rb.transpose(1, 2)
    tangent = gR - 0.5 * (M + M.transpose(1, 2)) @ Rb
    return float(torch.sqrt(torch.sum(tangent ** 2)
                            + torch.sum(s[1:] ** 2 * gs ** 2)))


class Stationary(NamedTuple):
    """A solve the program reports stopped at a gradient norm under ``tol``
    and does not certify (XM^2's rank-3 probe): its ``SolveResult``
    (``R``, ``s_ex``, ``primal``) and the ``lam`` it was solved at."""

    result: object
    lam: float
    tol: float


def judge_stationary(el: ref.Elimination, st: Stationary, device) -> dict:
    """``primal_err``: the reported primal against ``f`` at the factor;
    ``probe_grad``: the gradient norm there (:func:`gradnorm`) over
    ``tol``, which a solve stopped by its tolerance reads under 1."""
    r = st.result
    S = ref.scaled_factor(r.R, r.s_ex, torch.float64, device)
    f = objective(el.C, S, st.lam)
    return {"primal_err": abs(float(r.primal) - f) / abs(f),
            "probe_grad": gradnorm(el.C, r.R, r.s_ex, st.lam, device)
            / st.tol}


def judge_output(el: ref.Elimination, out, lam: float, limits: dict, gen,
                 device) -> dict:
    """``pb_judge.judge_output``'s readings of one output solved at
    ``lam``: the rounding and positions as it reads them (they depend on
    neither ``lam`` nor ``C``), the primal and the certificate against the
    penalised problem.  ``cert`` is read only of an output the program
    reports certified: a certificate claimed must hold, and XM^2 asks none
    of its first pass."""
    readings = pb_judge.judge_output(el, out, limits, gen, device)
    S = ref.scaled_factor(out.R, out.s_ex, torch.float64, device)
    cert = certificate(el.C, S, lam, limits["cert_bound"], gen)
    readings["primal_err"] = abs(out.primal - cert.primal) / abs(cert.primal)
    readings["cert"] = min(max(0.0, -cert.lam_min) / limits["cert_bound"],
                           (cert.gap / cert.primal) / limits["cert_gap"])
    if not out.certified:
        del readings["cert"]
    return readings


def judge_scene(el: ref.Elimination, X: torch.Tensor, applied: np.ndarray,
                judged: list, limits: dict, seed: int, k: int,
                device) -> dict:
    """``pb_judge.judge_scene`` of :class:`pb_judge.Judged` outputs, each
    at its own ``lam`` (identical outputs judged once)."""
    CX = el.C @ X
    got = torch.as_tensor(applied, dtype=torch.float64, device=device)
    worst = {"op_err": float(torch.linalg.norm(got - CX)
                             / torch.linalg.norm(CX))}
    gen = torch.Generator(device=device).manual_seed(
        pb_judge.seed_int(seed, k, 2))
    seen = set()
    for j in judged:
        key = j.output.key() + (j.lam,)
        if key in seen:
            continue
        seen.add(key)
        pb_judge.merge(worst, judge_output(el, j.output, j.lam, limits, gen,
                                           device))
    return worst


def judge_set(obs, X: torch.Tensor, applied: np.ndarray, judged: list,
              limits: dict, seed: int, k: int, device,
              control_dtype=None,
              stationary=()) -> "tuple[dict, dict | None]":
    """``pb_judge.judge_set`` for outputs solved at any ``lam``, all on the
    observation set ``obs``, and the program's readings of the
    :class:`Stationary` solves ``stationary`` on it; with ``control_dtype``
    the control's readings of the outputs: the reference in that precision
    in the program's place (its primal with the penalty added in that
    precision)."""
    ctrl = None
    if control_dtype is not None:
        applied_c, made = pb_judge.control_outputs(
            obs, [j.output for j in judged], X, control_dtype, device)
        made = [j._replace(output=m._replace(primal=m.primal + penalty(
            ref.scaled_factor(m.R, m.s_ex, control_dtype, device), j.lam)))
            for j, m in zip(judged, made)]
        ctrl = (applied_c, made)
    el = ref.eliminate(obs.edges, obs.weights, obs.landmarks, obs.N, obs.M,
                       torch.float64, device)
    prog = judge_scene(el, X, applied, judged, limits, seed, k, device)
    for st in stationary:
        pb_judge.merge(prog, judge_stationary(el, st, device))
    if ctrl is not None:
        ctrl = judge_scene(el, X, *ctrl, limits, seed, k, device)
    del el
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return prog, ctrl
