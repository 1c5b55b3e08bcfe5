"""Global positioning: BATA translation/position averaging on the card.

PyTorch counterpart of ``xmtpu/pipeline/global_positioning.py``, a
re-design of the reference GLOMAP fork's Ceres-based ``GlobalPositioner``
(deps/glomap/glomap/estimators/global_positioning.cc:24-82; cost
deps/glomap/glomap/estimators/cost_function.h:11-41), compiled but
disabled in XM's truncated pipeline (global_mapper.cc:188-390).

The BATA residual per constraint k is ``r_k = d_k - s_k (x_{j(k)} - c_{i(k)})``
with a per-residual scale ``s_k >= 1e-5`` and a Huber loss (delta = 1e-1,
GlobalPositionerOptions ctor).  Unknowns are camera centers (N, 3), point
positions (M, 3) and the scales, solved by the reference's alternating
scheme: closed-form optimal scales (global_positioning.cc:273-277), Huber
IRLS weights, and a variable-projection Gauss-Newton step by conjugate
gradient on the weighted graph Laplacian with the translation gauge
projected out.

The reference runs the whole solve as one jitted program; here its
``fori_loop``s are Python loops over tensors on ``device`` with no host
read inside, and the backtracking choice is a ``torch.argmin`` and an
index.  Its two scatters (``B^T v``: +v at ``dst``, -v at ``src``) are
segment sums over one stable permutation of the constraints by each end,
built once per call (:class:`xmtpu_torch.ops.segsum.Segments`), so on the
card they launch ``sorted_segment_sum`` and repeat their bits.  The random
start stays numpy on the host, so both packages start from the same point.

Constraint families mirror the reference: camera->camera directions from
relative poses rotated into the world frame (``-R_j^T t_ij``,
global_positioning.cc:163-166) and camera->point bearings
(``R_i^T u_ik``, global_positioning.cc:262-266), selected by
``constraint_type`` exactly as GlobalPositionerOptions.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from xmtpu_torch._device import resolve_device
from xmtpu_torch.ops.segsum import Segments


@dataclass
class PositionerOptions:
    """Mirrors GlobalPositionerOptions (global_positioning.h:9-47)."""

    constraint_type: str = "ONLY_POINTS"  # | ONLY_CAMERAS | POINTS_AND_CAMERAS
    #                                       | POINTS_AND_CAMERAS_BALANCED
    constraint_reweight_scale: float = 1.0
    min_num_view_per_track: int = 3
    huber_delta: float = 1e-1      # thres_loss_function (h:43-46)
    seed: int = 1
    position_scale: float = 100.0  # random init amplitude (cc:140-142)
    outer_iters: int = 64
    cg_iters: int = 12
    optimize_points: bool = True
    optimize_positions: bool = True
    optimize_scales: bool = True   # GlobalPositionerOptions (h:26-28); False
    #                                pins every per-residual scale at 1


_ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.01)


def _solve_bata(src, dst, d, w_fix, n_var, u0, delta, outer_iters, cg_iters,
                free_mask, fix_scales=False):
    """IRLS + variable-projection Gauss-Newton BATA core (the reference's
    jitted ``_solve_bata``).

    The per-residual scale is eliminated in closed form
    (``s* = max(d.e / ||e||^2, 1e-5)``), which makes the reduced residual
    ``r = (I - ee^T/e^Te) d`` and gives a Gauss-Newton step with the
    projected Jacobian ``J_k = s_k P_k B_k`` (Kaufman VarPro).  Each GN
    system is solved matrix-free by ``cg_iters`` CG steps (two segment sums
    per apply), the translation gauge is projected out, the scale gauge
    against the radial direction, and a 5-point backtracker keeps the
    robust cost monotone.

    src/dst: (K,) int numpy indices into the stacked unknowns u (n_var, 3);
    d: (K, 3) observed directions; w_fix: (K,) static per-residual weights;
    u0: (n_var, 3); free_mask: (n_var, 1) 1.0 where the unknown is
    optimized — tensors on the device the solve runs on.  Returns
    ``(u, s, rn, cost)`` as tensors; nothing is read back to the host.
    """
    dev = d.device
    by_dst = Segments(dst, n_var, dev, "BATA dst")
    by_src = Segments(src, n_var, dev, "BATA src")
    src = torch.as_tensor(np.asarray(src, dtype=np.int64), device=dev)
    dst = torch.as_tensor(np.asarray(dst, dtype=np.int64), device=dev)

    def edge_diff(u):
        return u[dst] - u[src]  # (K, 3)

    def gather_scatter(vals):
        # B^T vals: +vals at dst, -vals at src
        return by_dst.sum(vals) - by_src.sum(vals)

    def project(u):
        # remove the global-translation gauge and freeze non-optimized vars
        return (u - torch.mean(u, dim=0, keepdim=True)) * free_mask

    def scales_resid(u):
        e = edge_diff(u)
        ee = torch.clamp_min(torch.sum(e * e, dim=1), 1e-12)
        if fix_scales:
            s = torch.ones(e.shape[0], dtype=e.dtype, device=dev)
        else:
            s = torch.clamp_min(torch.sum(d * e, dim=1) / ee, 1e-5)
        r = d - s[:, None] * e
        return e, ee, s, r

    def huber(rn):
        return torch.sum(w_fix * torch.where(rn <= delta, 0.5 * rn * rn,
                                             delta * (rn - 0.5 * delta)))

    def robust_cost(u):
        _, _, _, r = scales_resid(u)
        return huber(torch.linalg.norm(r, dim=1))

    def vdot(a, b):
        return torch.sum(a * b)

    def outer_body(u):
        e, ee, s, r = scales_resid(u)
        rn = torch.linalg.norm(r, dim=1)
        w = w_fix * torch.clamp(delta / torch.clamp_min(rn, 1e-12),
                                max=1.0)  # Huber
        ws2 = w * s * s

        def P(v):  # per-edge projector I - ee^T/e^Te
            return v - (torch.sum(e * v, dim=1) / ee)[:, None] * e

        def H(v):
            return project(gather_scatter(ws2[:, None] * P(edge_diff(v))))

        b = project(gather_scatter((w * s)[:, None] * r))

        # CG for the GN step from zero
        x, rr, p = torch.zeros_like(u), b, b
        rs = vdot(rr, rr)
        for _ in range(cg_iters):
            Hp = H(p)
            alpha = rs / torch.clamp_min(vdot(p, Hp), 1e-30)
            x = x + alpha * p
            rr = rr - alpha * Hp
            rs_new = vdot(rr, rr)
            p = rr + (rs_new / torch.clamp_min(rs, 1e-30)) * p
            rs = rs_new
        step = x
        if not fix_scales:
            # remove the radial (global scale) null direction of the reduced
            # cost (eliminating s makes the cost scale-invariant; with fixed
            # scales the radial direction is a real degree of freedom)
            un = project(u)
            uu = torch.clamp_min(vdot(un, un), 1e-30)
            step = step - (vdot(step, un) / uu) * un

        # monotone multi-point backtracking on the robust cost: the first
        # minimum of the candidates' costs and the current one's, picked on
        # the device (an index_select; indexing with the 0-d argmin would
        # read it back to the host)
        cands = torch.stack([project(u + a * step) for a in _ALPHAS]
                            + [project(u)])
        costs = torch.stack([robust_cost(c) for c in cands[:-1]]
                            + [robust_cost(u)])
        return cands.index_select(0, torch.argmin(costs).reshape(1))[0]

    u = project(u0)
    for _ in range(outer_iters):
        u = outer_body(u)
    # final diagnostics
    _, _, s, r = scales_resid(u)
    rn = torch.linalg.norm(r, dim=1)
    return u, s, rn, huber(rn)


def global_positioning(cam_idx, tgt_idx, d_obs, n_cameras, n_points=0,
                       weights=None, init_positions=None, init_points=None,
                       opts: PositionerOptions = None, device=None):
    """Solve the BATA position problem on ``device`` (None = the CUDA card;
    raises without one unless ``"cpu"``).

    Args:
      cam_idx: (K,) camera index of each constraint's source camera.
      tgt_idx: (K,) target index; ``< n_cameras`` = another camera center,
        ``>= n_cameras`` = point ``tgt_idx - n_cameras``.
      d_obs: (K, 3) world-frame direction observations (need not be unit).
      weights: optional (K,) fixed per-residual weights (e.g. the 0.5
        down-weight for uncalibrated cameras, global_positioning.cc:283-296).
      init_positions/init_points: optional (N,3)/(M,3) initial values; when
        omitted, random as in the reference (cc:136-144, generate_random_*).

    Returns dict with ``positions`` (N,3) camera centers, ``points`` (M,3),
    ``scales`` (K,), ``residual_norms`` (K,), ``cost``.
    """
    dev = resolve_device(device)
    opts = opts or PositionerOptions()
    cam_idx = np.asarray(cam_idx, dtype=np.int32)
    tgt_idx = np.asarray(tgt_idx, dtype=np.int32)
    d_obs = np.asarray(d_obs, dtype=np.float64).reshape(-1, 3)
    K = d_obs.shape[0]
    n_var = n_cameras + n_points
    if K == 0:
        raise ValueError("no constraints")
    if weights is None:
        weights = np.ones(K)
    weights = np.asarray(weights, dtype=np.float64)

    rng = np.random.default_rng(opts.seed)
    u0 = np.empty((n_var, 3))
    if init_positions is not None:
        u0[:n_cameras] = np.asarray(init_positions, dtype=np.float64)
    else:
        u0[:n_cameras] = opts.position_scale * rng.uniform(
            -1, 1, size=(n_cameras, 3))
    if n_points:
        if init_points is not None:
            u0[n_cameras:] = np.asarray(init_points, dtype=np.float64)
        else:
            u0[n_cameras:] = opts.position_scale * rng.uniform(
                -1, 1, size=(n_points, 3))

    free = np.ones((n_var, 1))
    if not opts.optimize_positions:
        free[:n_cameras] = 0.0
    if not opts.optimize_points:
        free[n_cameras:] = 0.0

    def on(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    u, s, rn, cost = _solve_bata(
        cam_idx, tgt_idx, on(d_obs), on(weights), n_var, on(u0),
        float(opts.huber_delta), int(opts.outer_iters), int(opts.cg_iters),
        on(free), fix_scales=not opts.optimize_scales)
    u = u.cpu().numpy()
    return {"positions": u[:n_cameras], "points": u[n_cameras:],
            "scales": s.cpu().numpy(), "residual_norms": rn.cpu().numpy(),
            "cost": float(cost)}


def camera_constraints(pair_i, pair_j, R_world, t_rel):
    """Camera->camera BATA directions from relative poses.

    ``t_rel[k]`` is the relative translation of pair (i, j) in camera-j
    coordinates (cam2_from_cam1); ``R_world[j]`` the world-from-camera-j
    rotation estimate. Direction is ``-R_j t_ij`` expressed in world frame
    (global_positioning.cc:163-166, with rotation.inverse() on the
    world2cam convention == our cam2world R)."""
    R_world = np.asarray(R_world, dtype=np.float64)
    t_rel = np.asarray(t_rel, dtype=np.float64).reshape(-1, 3)
    d = -np.einsum("kab,kb->ka", R_world[np.asarray(pair_j, int)], t_rel)
    return np.asarray(pair_i, int), np.asarray(pair_j, int), d


def point_constraints(obs_cam, obs_track, bearings, R_world, n_cameras,
                      min_num_view_per_track: int = 3):
    """Camera->point BATA directions from feature bearings.

    ``bearings[k]`` is the undistorted feature direction in camera
    ``obs_cam[k]``'s frame toward track ``obs_track[k]``; rotated into world
    by the camera rotation (global_positioning.cc:262-266). Tracks shorter
    than ``min_num_view_per_track`` are dropped (cc:231, h:32-33).

    Returns ``(cam_idx, tgt_idx, d, track_keep)`` where tgt_idx indexes the
    stacked unknown vector (points offset by n_cameras, reindexed densely)."""
    obs_cam = np.asarray(obs_cam, int)
    obs_track = np.asarray(obs_track, int)
    bearings = np.asarray(bearings, dtype=np.float64).reshape(-1, 3)
    R_world = np.asarray(R_world, dtype=np.float64)

    n_tracks = obs_track.max() + 1 if obs_track.size else 0
    counts = np.bincount(obs_track, minlength=n_tracks)
    track_keep = counts >= min_num_view_per_track
    keep = track_keep[obs_track]
    obs_cam, obs_track, bearings = (obs_cam[keep], obs_track[keep],
                                    bearings[keep])
    new_id = np.cumsum(track_keep) - 1
    tgt = n_cameras + new_id[obs_track]
    d = np.einsum("kab,kb->ka", R_world[obs_cam], bearings)
    return obs_cam, tgt.astype(int), d, track_keep
