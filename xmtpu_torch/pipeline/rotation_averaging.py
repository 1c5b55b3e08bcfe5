"""Robust global rotation averaging — the GLOMAP stage XM uses to filter
bad relative poses.

PyTorch counterpart of ``xmtpu/pipeline/rotation_averaging.py`` (the
vendored Theia-style ``RotationEstimator``,
deps/glomap/glomap/estimators/global_rotation_averaging.{h,cc}): given
relative rotations ``R_rel = R_j R_i^T`` on a view graph, estimate global
rotations by the reference's three phases —

1. **Maximum-spanning-tree initialization** (cc:63-111), numpy on the host
   as in the reference;
2. **L1 phase** (``SolveL1Regression``, cc:277-331): the linearized system
   ``x_j - x_i = r_e`` (+ one pin row for camera 0) solved in the L1 norm
   by :mod:`xmtpu_torch.ops.l1`, with the doubling inner cap (10 -> 100)
   and the average-step stop;
3. **IRLS phase** (``SolveIRLS``, cc:334-419): Geman-McClure weights with
   sigma = 5 degrees and a weighted CG of ``cg_iters`` steps.

The graph operators sum over the pair ends, which are not sorted: the
reference's ``jax.ops.segment_sum`` there is an XLA scatter, not one of its
Pallas kernels, and the port takes ``index_add_``.  On the card its f64
atomics change the last bits from run to run; the filter's 10 degree
threshold sits far from the residuals of clean and corrupted pairs.

The reference runs both phases as one jitted program.  Here every fixed-count
CG loop runs without a host read (its ``live`` guard is a ``torch.where``);
each ``while_loop`` condition of the reference — the ADMM's, the L1
phase's and the IRLS phase's — reads one flag back per iteration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from xmtpu_torch._device import resolve_device
from xmtpu_torch.ops.l1 import make_l1_admm
from xmtpu_torch.pipeline.refine import _expm_so3  # zero-safe Rodrigues


def _log_so3(R):
    """Batched SO(3) log map: (..., 3, 3) -> (..., 3).  The reference's
    branches near angle 0 and pi, each selected with ``torch.where`` so that
    the untaken branch's infinities never reach the result."""
    tr = torch.diagonal(R, dim1=-2, dim2=-1).sum(-1)
    cos = torch.clamp((tr - 1) / 2, -1.0, 1.0)
    theta = torch.arccos(cos)
    # axis from the skew part; safe at theta ~ 0 and theta ~ pi
    skew = 0.5 * (R - R.transpose(-1, -2))
    w = torch.stack([skew[..., 2, 1], skew[..., 0, 2], skew[..., 1, 0]],
                    dim=-1)
    sin = torch.sin(theta)
    small = theta < 1e-6
    scale = torch.where(small, 1.0, theta / torch.where(small, 1.0, sin))
    near_pi = theta > np.pi - 1e-3
    # near pi: use the symmetric part diagonal
    A = (0.5 * (R + R.transpose(-1, -2))
         - torch.eye(3, dtype=R.dtype, device=R.device))
    diag = torch.clamp_min(1.0 + torch.stack(
        [A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]], dim=-1), 0.0)
    axis_pi = torch.sqrt(diag)
    sign = torch.sign(torch.where(torch.abs(w) > 1e-12, w, 1.0))
    w_pi = theta[..., None] * axis_pi * sign
    return torch.where(near_pi[..., None], w_pi, scale[..., None] * w)


@dataclass
class RotationEstimatorOptions:
    """Mirrors glomap RotationEstimatorOptions
    (global_rotation_averaging.h:36-72)."""

    max_num_l1_iterations: int = 5
    l1_step_convergence_threshold: float = 0.001
    max_num_irls_iterations: int = 100
    irls_step_convergence_threshold: float = 0.001
    irls_loss_parameter_sigma: float = 5.0     # degrees
    weight_type: str = "GEMAN_MCCLURE"         # | "HALF_NORM"
    skip_initialization: bool = False
    cg_iters: int = 64


class RotationAveragingResult(NamedTuple):
    rotations: np.ndarray   # (N, 3, 3) global rotations, R_0 = I
    residual_angles: np.ndarray  # (E,) per-pair residual angle (rad)


def _spanning_tree_init(i_idx, j_idx, R_rel, N, weights=None):
    """Chain relative rotations down the maximum spanning tree
    (InitializeFromMaximumSpanningTree, cc:63-111; inlier counts as weights).
    With unit weights this reduces to BFS chaining."""
    order = np.argsort(-(np.ones(len(i_idx)) if weights is None
                         else np.asarray(weights, dtype=np.float64)))
    # Kruskal on the sorted edges (maximum spanning forest)
    parent = np.arange(N)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    adj = [[] for _ in range(N)]
    for e in order:
        a, b = find(i_idx[e]), find(j_idx[e])
        if a != b:
            parent[a] = b
            adj[i_idx[e]].append((j_idx[e], e, False))
            adj[j_idx[e]].append((i_idx[e], e, True))

    R = np.tile(np.eye(3), (N, 1, 1))
    seen = np.zeros(N, bool)
    stack = [0]
    seen[0] = True
    while stack:
        i = stack.pop()
        for (j, e, inv) in adj[i]:
            if seen[j]:
                continue
            seen[j] = True
            # R_rel[e] = R_j R_i^T  =>  R_j = R_rel[e] R_i
            R[j] = (R_rel[e].T if inv else R_rel[e]) @ R[i]
            stack.append(j)
    return R, seen


def _build_solver(E, N, i_j, j_j, fix, opts):
    """Both solve phases on the device of ``i_j``/``j_j``."""
    sigma = np.radians(opts.irls_loss_parameter_sigma)
    half_norm = opts.weight_type == "HALF_NORM"

    def A_mul(x):
        return (x[j_j] - x[i_j], x[fix])

    def At_mul(y):
        ye, yf = y
        out = (torch.zeros((N, 3), dtype=ye.dtype, device=ye.device)
               .index_add_(0, j_j, ye)
               - torch.zeros((N, 3), dtype=ye.dtype, device=ye.device)
               .index_add_(0, i_j, ye))
        out[fix] += yf
        return out

    admm = make_l1_admm(A_mul, At_mul, 3 * (E + 1), 3 * N,
                        cg_iters=opts.cg_iters)

    def residuals(R, Rr, R_fix0):
        # r_e = -log(R_j^T R_rel R_i)  (ComputeResiduals, cc:467-469)
        Rerr = R[j_j].transpose(-1, -2) @ Rr @ R[i_j]
        r_e = -_log_so3(Rerr)
        r_f = _log_so3(R_fix0.T @ R[fix])
        return r_e, r_f

    def update(R, x):
        # R <- R exp(-x)  (UpdateGlobalRotations, cc:429-433)
        return R @ _expm_so3(-x)

    def avg_step(x):
        return torch.mean(torch.linalg.norm(x, dim=1))

    def cg_weighted(w_e, r_e, r_f):
        """CG on A^T W A x = A^T W r (SolveIRLS, cc:395-404)."""
        rhs = At_mul((w_e[:, None] * r_e, r_f))

        def AtWA(x):
            ye, yf = A_mul(x)
            return At_mul((w_e[:, None] * ye, yf))

        x = torch.zeros((N, 3), dtype=r_e.dtype, device=r_e.device)
        r = p = rhs
        rs = torch.dot(rhs.reshape(-1), rhs.reshape(-1))
        for _ in range(opts.cg_iters):
            live = rs > 1e-30
            Ap = AtWA(p)
            pAp = torch.dot(p.reshape(-1), Ap.reshape(-1))
            a = torch.where(live, rs / torch.where(pAp == 0, 1.0, pAp), 0.0)
            x = x + a * p
            r = r - a * Ap
            rs_new = torch.dot(r.reshape(-1), r.reshape(-1))
            beta = torch.where(live, rs_new / rs, 0.0)
            p = r + beta * p
            rs = rs_new
        return x

    def solve(R0, Rr):
        R_fix0 = R0[fix]
        zero = torch.zeros((N, 3), dtype=R0.dtype, device=R0.device)

        # ---- L1 phase (SolveL1Regression, cc:277-331) ----
        R, k, cap = R0, 0, 10
        last_norm = torch.zeros((), dtype=R0.dtype, device=R0.device)
        done = opts.max_num_l1_iterations == 0
        while not done and k < opts.max_num_l1_iterations:
            r_e, r_f = residuals(R, Rr, R_fix0)
            x = admm((r_e, r_f), zero, cap)
            curr_norm = torch.linalg.norm(x)
            R = update(R, x)
            done = bool((avg_step(x) < opts.l1_step_convergence_threshold)
                        | (torch.abs(last_norm - curr_norm) < 1e-12))
            k, cap, last_norm = k + 1, min(cap * 2, 100), curr_norm

        # ---- IRLS phase (SolveIRLS, cc:334-419) ----
        k = 0
        done = opts.max_num_irls_iterations == 0
        while not done and k < opts.max_num_irls_iterations:
            r_e, r_f = residuals(R, Rr, R_fix0)
            e2 = torch.sum(r_e * r_e, dim=1)
            if half_norm:
                w = torch.pow(torch.clamp_min(e2, 1e-20), (0.5 - 2.0) / 2.0)
            else:
                tmp = e2 + sigma * sigma
                w = sigma * sigma / (tmp * tmp)
            x = cg_weighted(w, r_e, r_f)
            R = update(R, x)
            done = bool(avg_step(x) < opts.irls_step_convergence_threshold)
            k += 1

        r_e, _ = residuals(R, Rr, R_fix0)
        return R, torch.linalg.norm(r_e, dim=1)

    return solve


def rotation_averaging(pairs, R_rel, N, weights=None,
                       opts: RotationEstimatorOptions | None = None,
                       device=None) -> RotationAveragingResult:
    """Estimate global rotations from pairwise relative rotations.

    Args:
      pairs: (E, 2) 0-based camera index pairs (i, j).
      R_rel: (E, 3, 3) relative rotations with convention
        ``R_rel = R_j R_i^T`` (maps camera-i frame to camera-j frame).
      weights: optional (E,) MST weights (the reference uses pair inlier
        counts, cc:67).
      device: where the two solve phases run (None = the CUDA card).
    """
    dev = resolve_device(device)
    opts = opts or RotationEstimatorOptions()
    pairs = np.asarray(pairs)
    R_rel = np.asarray(R_rel, dtype=np.float64)
    i_idx = pairs[:, 0]
    j_idx = pairs[:, 1]

    if opts.skip_initialization:
        R0, seen = np.tile(np.eye(3), (N, 1, 1)), np.ones(N, bool)
    else:
        R0, seen = _spanning_tree_init(i_idx, j_idx, R_rel, N, weights)
        if not seen.all():
            raise ValueError("view graph is not connected")

    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    solve = _build_solver(len(pairs), N, idx(i_idx), idx(j_idx), 0, opts)
    R, ang = solve(torch.as_tensor(R0, device=dev),
                   torch.as_tensor(R_rel, device=dev))

    # gauge-fix by right multiplication (preserves all relative rotations,
    # sets R_0 = I)
    R = R.cpu().numpy()
    R_out = R @ R[0].T[None]
    return RotationAveragingResult(R_out, ang.cpu().numpy())


def filter_pairs(pairs, R_rel, N, max_angle_deg: float = 10.0, weights=None,
                 opts: RotationEstimatorOptions | None = None, device=None):
    """Run rotation averaging and drop relative poses whose residual exceeds
    ``max_angle_deg`` — XM's use of the stage (global_mapper.cc:77-111 runs
    it twice purely as a filter)."""
    result = rotation_averaging(pairs, R_rel, N, weights=weights, opts=opts,
                                device=device)
    keep = result.residual_angles < np.radians(max_angle_deg)
    return keep, result
