"""Global bundle adjustment: Schur-complement Levenberg-Marquardt on the card.

PyTorch counterpart of ``xmtpu/pipeline/bundle_adjustment.py``, a
re-design of the GLOMAP ``BundleAdjuster``
(deps/glomap/glomap/estimators/bundle_adjustment.{h,cc}) and its stage-6
orchestration in ``GlobalMapper::Solve``
(deps/glomap/glomap/controllers/global_mapper.cc:233-322, present but
disabled in the XM fork).  The reference builds a Ceres problem — one
``ReprojErrorCostFunctor`` residual block per observation, Huber loss with
threshold 1 (bundle_adjustment.h:23-25), quaternion manifolds, the first
image fixed for gauge (bundle_adjustment.cc:146-160), principal point held
constant (cc:167-175), SPARSE_SCHUR with points eliminated (cc:40, 98-126).

The same nonlinear least-squares problem is solved as the JAX package does:

* per-observation residuals and their 2x15 Jacobian blocks (pose,
  intrinsics, point) come from one ``torch.func.vmap(torch.func.jacfwd)``
  over the observations, evaluated at ``delta = 0``;
* the point blocks are eliminated as in SPARSE_SCHUR: the block-diagonal
  ``H_pp`` is summed by track and inverted as a batch of 3x3 systems, and
  the reduced camera system is applied matrix-free per edge;
* the reduced system is solved by a fixed ``cg_iterations`` PCG loop with
  exact block-Jacobi preconditioning, with no host read inside (the
  reference's ``live`` guard is a ``torch.where``); each apply forms
  ``H_cc u - H_cp z`` as one sum of ``J_c^T (a - q)`` over the edges where
  the reference subtracts two (the same quantity, summed in another
  order), so it makes three segment sums, not nine;
* Huber robustness enters as IRLS weights at every linearization;
* the LM accept/reject and lambda schedule run on the host, which reads two
  scalars per LM step as the reference does (counted in
  ``bundle_adjustment.host_reads``).

Every segment sum goes through ``sorted_segment_sum``
(:class:`xmtpu_torch.ops.segsum.Segments`): the edges of one
``bundle_adjustment`` call are sorted by image once (stably, on the host),
so the sums by image need no gather; the sums by track gather through a
second stable permutation; the sums by camera add the per-image sums of
the intrinsics rows by ``camera_of_image`` (a sum over the N images, never
a launch that adds all edges of one camera in one thread).  The camera sums
therefore add in another order than the reference's edge-order scatter.

Intrinsics use the generic ``(fx, fy, cx, cy, k1, k2, p1, p2)`` layout
(the principal point stays fixed, matching the reference's subset
manifold); ``Camera`` instances from :mod:`xmtpu_torch.pipeline.undistort`
are converted with :func:`generic_params`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from xmtpu_torch._device import resolve_device
from xmtpu_torch.ops.segsum import Segments
from xmtpu_torch.pipeline.refine import _expm_so3


@dataclass
class BundleAdjusterOptions:
    """Mirrors glomap BundleAdjusterOptions (bundle_adjustment.h:11-27)."""

    optimize_rotations: bool = True
    optimize_translation: bool = True
    optimize_intrinsics: bool = True
    optimize_points: bool = True
    min_num_view_per_track: int = 3     # bundle_adjustment.h:20
    huber_threshold: float = 1.0        # thres_loss_function (h:23)
    max_iterations: int = 200           # solver_options (h:25)
    cg_iterations: int = 100
    function_tolerance: float = 1e-6    # Ceres default
    verbose: bool = False


class BAResult(NamedTuple):
    R: np.ndarray            # (N, 3, 3) cam_from_world rotations
    t: np.ndarray            # (N, 3) cam_from_world translations
    xyz: np.ndarray          # (M, 3) track positions
    cam_params: np.ndarray   # (C, 8) generic intrinsics
    cost_initial: float      # robust cost before
    cost_final: float        # robust cost after
    iterations: int
    success: bool            # Ceres summary.IsSolutionUsable analog


_GENERIC_DIM = 8


def generic_params(camera) -> np.ndarray:
    """Camera -> (fx, fy, cx, cy, k1, k2, p1, p2).

    Exact for the reference's non-fisheye family (see
    xmtpu/pipeline/undistort.py model table); FULL_OPENCV's rational /
    fisheye terms are not representable and raise.
    """
    K = camera.K
    d = camera.dist
    out = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0.0, 0.0, 0.0, 0.0])
    m = camera.model
    if m in ("SIMPLE_PINHOLE", "PINHOLE") or d.size == 0:
        return out
    if m == "SIMPLE_RADIAL":
        out[4] = d[0]
        return out
    if m == "RADIAL":
        out[4:6] = d[:2]
        return out
    if m == "OPENCV":
        out[4:8] = d[:4]
        return out
    raise ValueError(f"camera model {m} has no exact generic-BA form")


def _project_generic(params, x_cam, eps=1e-12):
    """Camera-frame point -> pixel through the generic model (one edge).

    The z-clamp keeps the residual finite behind the camera; the robust
    weight then downweights such observations (the reference filters them
    out before BA instead)."""
    z = torch.where(torch.abs(x_cam[2]) < eps, eps, x_cam[2])
    xy = x_cam[:2] / z
    x, y = xy[0], xy[1]
    r2 = x * x + y * y
    k1, k2, p1, p2 = params[4], params[5], params[6], params[7]
    radial = 1.0 + r2 * (k1 + r2 * k2)
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return params[:2] * torch.stack([xd, yd]) + params[2:4]


def _edge_residual(delta, R0, t0, X0, cam0, obs):
    """Residual of one observation at perturbation ``delta`` (15,):
    [omega(3), dt(3), dintr(6: dfx dfy dk1 dk2 dp1 dp2), dX(3)].

    Rotation update is the left-multiplied exponential map — the quaternion
    manifold analog (bundle_adjustment.cc:146-149)."""
    w, dt, di, dX = delta[:3], delta[3:6], delta[6:12], delta[12:15]
    R = _expm_so3(w) @ R0
    x_cam = R @ (X0 + dX) + t0 + dt
    cam = cam0 + torch.cat([di[:2], torch.zeros_like(di[:2]), di[2:]])
    return _project_generic(cam, x_cam) - obs


_edge_residual_batch = torch.func.vmap(_edge_residual)
_edge_jac_batch = torch.func.vmap(torch.func.jacfwd(_edge_residual))


def _spd_inv(H):
    """Batched SPD inverse via Cholesky.  Where the factorization fails the
    reference's ``cholesky`` gives NaN, and so does this: the trial cost is
    then NaN and the LM step is rejected."""
    L, info = torch.linalg.cholesky_ex(H)
    L = torch.where((info == 0)[..., None, None], L, torch.nan)
    eye = torch.eye(H.shape[-1], dtype=H.dtype,
                    device=H.device).expand(H.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.einsum("...ka,...kb->...ab", Linv, Linv)


def _huber_weight(sq_norm, a):
    """First-order IRLS weight of Ceres HuberLoss(a): rho'(s)."""
    s = torch.clamp_min(sq_norm, 1e-30)
    return torch.where(s <= a * a, 1.0, a / torch.sqrt(s))


def _huber_cost(sq_norm, a):
    return torch.where(sq_norm <= a * a, sq_norm,
                       2.0 * a * torch.sqrt(torch.clamp_min(sq_norm, 1e-30))
                       - a * a)


class _EdgeSums(NamedTuple):
    """The segment sums of one BA solve (edges sorted by image)."""

    image: Segments    # edges -> N images
    track: Segments    # edges -> M tracks
    camera: Segments   # images -> C cameras

    def by_camera(self, vals):
        """Edge rows summed by camera: by image, then the (N, ...) image
        sums by ``camera_of_image``."""
        return self.camera.sum(self.image.sum(vals))


def _make_step_fn(cg_iters, sums: _EdgeSums):
    """Build the (linearize + Schur-PCG + update) step of one BA solve; the
    host LM loop feeds lambda and accepts/rejects."""

    def linearize(R, t, X, cams, obs, i_idx, c_idx, j_idx, masks, huber):
        zero = torch.zeros((obs.shape[0], 15), dtype=R.dtype,
                           device=R.device)
        args = (zero, R[i_idx], t[i_idx], X[j_idx], cams[c_idx], obs)
        r = _edge_residual_batch(*args)                            # (E, 2)
        J = _edge_jac_batch(*args)                                 # (E, 2, 15)
        sq = torch.sum(r * r, dim=1)
        cost = 0.5 * torch.sum(_huber_cost(sq, huber))
        w = _huber_weight(sq, huber)
        sw = torch.sqrt(w)[:, None]
        rw = r * sw                                                # (E, 2)
        Jw = J * sw[:, :, None]
        m_pose, m_intr, m_pt = masks
        Jc = torch.cat([Jw[:, :, :6] * m_pose[i_idx][:, None, None],
                        Jw[:, :, 6:12] * m_intr[c_idx][:, None, None]],
                       dim=2)                                      # (E, 2, 12)
        Jp = Jw[:, :, 12:15] * m_pt                                # (E, 2, 3)
        return r, rw, Jc, Jp, cost

    def step(R, t, X, cams, obs, i_idx, c_idx, j_idx, masks,
             rot_mask, trans_mask, huber, lam):
        _, rw, Jc, Jp, cost = linearize(
            R, t, X, cams, obs, i_idx, c_idx, j_idx, masks, huber)
        dev, dt = R.device, R.dtype
        # rot/trans freeze (bundle_adjustment.cc:150-157): zero those columns
        col = torch.cat([torch.full((3,), rot_mask, dtype=dt, device=dev),
                         torch.full((3,), trans_mask, dtype=dt, device=dev),
                         torch.ones((6,), dtype=dt, device=dev)])
        Jc = Jc * col[None, None, :]
        Jpose, Jintr = Jc[:, :, :6], Jc[:, :, 6:]

        # the points' gradient block (the cameras' enters the RHS below)
        gp = sums.track.sum(torch.einsum("eri,er->ei", Jp, rw))     # (M, 3)

        # block-diagonal Hessians
        Hpose = sums.image.sum(
            torch.einsum("era,erb->eab", Jpose, Jpose))             # (N, 6, 6)
        Hintr = sums.by_camera(
            torch.einsum("era,erb->eab", Jintr, Jintr))             # (C, 6, 6)
        Hpp = sums.track.sum(
            torch.einsum("era,erb->eab", Jp, Jp))                   # (M, 3, 3)

        # LM damping: lambda * clip(diag H) (Ceres' scaled diagonal), with
        # an absolute floor so frozen/unobserved blocks stay invertible
        def damped(H):
            d = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), 1e-6, 1e32)
            eye = torch.eye(H.shape[-1], dtype=dt, device=dev)
            return H + eye * (lam * d)[..., None, :]

        Hpp_inv = _spd_inv(damped(Hpp))                             # (M, 3, 3)
        P_pose = _spd_inv(damped(Hpose))                            # precond
        P_intr = _spd_inv(damped(Hintr))

        dp_diag = torch.clamp(torch.diagonal(Hpose, dim1=-2, dim2=-1),
                              1e-6, 1e32)
        di_diag = torch.clamp(torch.diagonal(Hintr, dim1=-2, dim2=-1),
                              1e-6, 1e32)

        def by_camera_block(v):
            """J_c^T v summed by image, then split into the pose block
            (N, 6) and the intrinsics block summed by camera (C, 6): one
            image sum of (E, 12) rows where the reference sums each block
            by its own scatter."""
            h = sums.image.sum(torch.einsum("era,er->ea", Jc, v))
            return h[:, :6], sums.camera.sum(h[:, 6:])

        def S_mul(u_pose, u_intr):
            """(H_cc + lam D - H_cp Hpp_d^-1 H_pc) u, matrix-free per edge:
            H_cc u - H_cp z = J_c^T (a - q) in one sum."""
            a = (torch.einsum("era,ea->er", Jpose, u_pose[i_idx])
                 + torch.einsum("era,ea->er", Jintr, u_intr[c_idx]))
            # H_pc u, eliminate, back
            hp = sums.track.sum(torch.einsum("era,er->ea", Jp, a))
            z = torch.einsum("mab,mb->ma", Hpp_inv, hp)
            q = torch.einsum("era,ea->er", Jp, z[j_idx])
            hc_pose, hc_intr = by_camera_block(a - q)
            return (hc_pose + lam * dp_diag * u_pose,
                    hc_intr + lam * di_diag * u_intr)

        # reduced RHS: b = -g_c + H_cp Hpp_d^-1 g_p = J_c^T (qe - rw)
        zp = torch.einsum("mab,mb->ma", Hpp_inv, gp)
        qe = torch.einsum("era,ea->er", Jp, zp[j_idx])
        b_pose, b_intr = by_camera_block(qe - rw)

        def precond(rp, ri):
            return (torch.einsum("nab,nb->na", P_pose, rp),
                    torch.einsum("cab,cb->ca", P_intr, ri))

        def dot(a, b):
            return torch.sum(a[0] * b[0]) + torch.sum(a[1] * b[1])

        x = (torch.zeros_like(b_pose), torch.zeros_like(b_intr))
        rr = (b_pose, b_intr)
        p = precond(*rr)
        rz = dot(rr, p)
        for _ in range(cg_iters):
            live = rz > 1e-30
            Ap = S_mul(*p)
            pAp = dot(p, Ap)
            alpha = torch.where(live, rz / torch.where(pAp == 0, 1.0, pAp),
                                0.0)
            x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
            rr = (rr[0] - alpha * Ap[0], rr[1] - alpha * Ap[1])
            zz = precond(*rr)
            rz_new = dot(rr, zz)
            beta = torch.where(live, rz_new / rz, 0.0)
            p = (zz[0] + beta * p[0], zz[1] + beta * p[1])
            rz = rz_new
        du_pose, du_intr = x

        # back-substitution: du_p = -Hpp_d^-1 (g_p + H_pc du_c)
        a = (torch.einsum("era,ea->er", Jpose, du_pose[i_idx])
             + torch.einsum("era,ea->er", Jintr, du_intr[c_idx]))
        hp = sums.track.sum(torch.einsum("era,er->ea", Jp, a))
        du_pt = -torch.einsum("mab,mb->ma", Hpp_inv, gp + hp)

        # apply (masks already folded into the Jacobians; re-apply so frozen
        # blocks move exactly zero, not just lambda-suppressed)
        m_pose, m_intr, m_pt = masks
        dw = du_pose[:, :3] * (rot_mask * m_pose)[:, None]
        dt_ = du_pose[:, 3:] * (trans_mask * m_pose)[:, None]
        di = du_intr * m_intr[:, None]
        dX = du_pt * m_pt

        R_new = _expm_so3(dw) @ R
        t_new = t + dt_
        X_new = X + dX
        cams_new = cams + torch.cat([di[:, :2], torch.zeros_like(di[:, :2]),
                                     di[:, 2:]], dim=1)

        zero = torch.zeros((obs.shape[0], 15), dtype=dt, device=dev)
        r_new = _edge_residual_batch(zero, R_new[i_idx], t_new[i_idx],
                                     X_new[j_idx], cams_new[c_idx], obs)
        sq_new = torch.sum(r_new * r_new, dim=1)
        cost_new = 0.5 * torch.sum(_huber_cost(sq_new, huber))
        return (R_new, t_new, X_new, cams_new), cost, cost_new

    return step


def bundle_adjustment(obs_image, obs_xy, obs_track, R, t, xyz,
                      cam_params, camera_of_image,
                      opts: BundleAdjusterOptions | None = None,
                      fixed_image: int | None = None,
                      device=None) -> BAResult:
    """Robust global BA over (poses, points, intrinsics) on ``device``
    (None = the CUDA card; raises without one unless ``"cpu"``).

    Args:
      obs_image: (E,) image index per observation.
      obs_xy: (E, 2) raw pixel keypoints (the reference's residual target,
        bundle_adjustment.cc:76-78).
      obs_track: (E,) track index per observation.
      R, t: (N, 3, 3) / (N, 3) cam_from_world poses.
      xyz: (M, 3) track positions.
      cam_params: (C, 8) generic intrinsics (see :func:`generic_params`).
      camera_of_image: (N,) camera index per image.
      fixed_image: gauge anchor; defaults to the first observed image in
        the caller's order (bundle_adjustment.cc:158-162 fixes the first
        image seen).
    """
    dev = resolve_device(device)
    opts = opts or BundleAdjusterOptions()
    obs_image = np.asarray(obs_image, dtype=np.int64)
    obs_track = np.asarray(obs_track, dtype=np.int64)
    obs_xy = np.asarray(obs_xy, dtype=np.float64)
    cam_of = np.asarray(camera_of_image, dtype=np.int64)
    N, M = len(R), len(xyz)
    C = len(cam_params)

    # min_num_view_per_track gate (bundle_adjustment.cc:67): constraints from
    # short tracks are skipped (their points keep their current positions)
    track_sizes = np.bincount(obs_track, minlength=M)
    keep = track_sizes[obs_track] >= opts.min_num_view_per_track
    E = int(keep.sum())
    if E == 0 or N == 0 or M == 0:
        return BAResult(np.asarray(R), np.asarray(t), np.asarray(xyz),
                        np.asarray(cam_params), 0.0, 0.0, 0, False)

    if fixed_image is None:
        fixed_image = int(obs_image[keep][0])
    # the edges sorted by image once (stable): the image sums need no gather
    order = np.argsort(obs_image[keep], kind="stable")
    i_np = obs_image[keep][order]
    j_np = obs_track[keep][order]
    sums = _EdgeSums(Segments(i_np, N, dev, "BA image"),
                     Segments(j_np, M, dev, "BA track"),
                     Segments(cam_of, C, dev, "BA camera"))

    def idx(a):
        return torch.as_tensor(a, dtype=torch.int64, device=dev)

    def f64(a):
        return torch.as_tensor(np.array(a, dtype=np.float64), device=dev)

    i_idx, j_idx, c_idx = idx(i_np), idx(j_np), idx(cam_of[i_np])
    obs = f64(obs_xy[keep][order])

    m_pose = np.ones(N)
    m_pose[fixed_image] = 0.0                       # gauge (cc:158-162)
    m_pose[np.bincount(i_np, minlength=N) == 0] = 0.0
    m_intr = np.full(C, 1.0 if opts.optimize_intrinsics else 0.0)
    m_pt = 1.0 if opts.optimize_points else 0.0
    masks = (f64(m_pose), f64(m_intr), m_pt)
    rot_mask = 1.0 if opts.optimize_rotations else 0.0
    trans_mask = 1.0 if opts.optimize_translation else 0.0

    step = _make_step_fn(opts.cg_iterations, sums)

    Rj, tj, Xj, camsj = f64(R), f64(t), f64(xyz), f64(cam_params)

    lam = 1e-4
    cost0 = None
    cost_prev = None
    it = 0
    for it in range(opts.max_iterations):
        (R_new, t_new, X_new, cams_new), cost, cost_new = step(
            Rj, tj, Xj, camsj, obs, i_idx, c_idx, j_idx, masks,
            rot_mask, trans_mask, opts.huber_threshold, lam)
        cost_f, cost_new_f = float(cost), float(cost_new)
        bundle_adjustment.host_reads += 2
        if cost0 is None:
            cost0 = cost_f
        accept = cost_new_f < cost_f
        if opts.verbose:
            print(f"[ba] it={it} cost={cost_f:.6e} -> {cost_new_f:.6e} "
                  f"accept={accept} lam={lam:.1e}")
        if accept:
            Rj, tj, Xj, camsj = R_new, t_new, X_new, cams_new
            lam = max(lam / 3.0, 1e-12)
            if (cost_prev is not None and
                    abs(cost_prev - cost_new_f)
                    < opts.function_tolerance * max(1.0, cost_new_f)):
                cost_prev = cost_new_f
                break
            cost_prev = cost_new_f
        else:
            lam = min(lam * 2.0, 1e12)
            if lam >= 1e12:
                break

    final = cost_prev if cost_prev is not None else cost0

    def host(a):
        return a.cpu().numpy()

    return BAResult(host(Rj), host(tj), host(Xj), host(camsj), float(cost0),
                    float(final), it + 1, np.isfinite(final))


# scalars the LM loops read back from the device (two per LM step)
bundle_adjustment.host_reads = 0


def run_bundle_adjustment(obs_image, obs_xy, obs_track, R, t, xyz,
                          cam_params, camera_of_image, features_undist=None,
                          opts: BundleAdjusterOptions | None = None,
                          num_iterations: int = 3,
                          max_reprojection_error: float = 1e-2,
                          min_triangulation_angle: float = 1.0,
                          verbose: bool = False, device=None):
    """Stage-6 orchestration (global_mapper.cc:233-322): staged BA
    (positions first, then rotations), normalization, and progressively
    tightened reprojection filtering.

    ``features_undist`` (E, 3) are the undistorted rays used by the
    normalized-image track filter (track_filter.cc:23-30); if None they are
    computed from the generic intrinsics.

    ``device``: where each BA solve runs (None = the CUDA card).

    Returns (keep_mask_over_input_observations, R, t, xyz, cam_params).
    """
    from .normalize import normalize_reconstruction
    from .track_filter import (filter_track_triangulation_angle,
                               filter_tracks_by_reprojection)

    device = resolve_device(device)
    opts = opts or BundleAdjusterOptions()
    obs_image = np.asarray(obs_image, dtype=np.int64)
    obs_track = np.asarray(obs_track, dtype=np.int64)
    obs_xy = np.asarray(obs_xy, dtype=np.float64)
    E0 = len(obs_image)
    alive = np.ones(E0, dtype=bool)
    M = len(xyz)

    if features_undist is None:
        features_undist = _undistorted_rays(obs_xy, cam_params,
                                            np.asarray(camera_of_image)[obs_image])
    features_undist = np.asarray(features_undist, dtype=np.float64)

    def edges(mask):
        return np.stack([obs_image[mask], obs_track[mask]], axis=1)

    ite = 0
    while ite < num_iterations:
        sel = alive
        # 6.1 positions only (global_mapper.cc:247-256)
        o1 = BundleAdjusterOptions(**{**opts.__dict__,
                                      "optimize_rotations": False,
                                      "verbose": False})
        res = bundle_adjustment(obs_image[sel], obs_xy[sel], obs_track[sel],
                                R, t, xyz, cam_params, camera_of_image, o1,
                                device=device)
        R, t, xyz, cam_params = res.R, res.t, res.xyz, res.cam_params
        if verbose:
            print(f"[ba-stage] ite={ite} stage1 cost {res.cost_initial:.4e} "
                  f"-> {res.cost_final:.4e}")
        # 6.2 rotations too (cc:258-268)
        if opts.optimize_rotations:
            res = bundle_adjustment(obs_image[sel], obs_xy[sel],
                                    obs_track[sel], R, t, xyz, cam_params,
                                    camera_of_image, opts, device=device)
            R, t, xyz, cam_params = res.R, res.t, res.xyz, res.cam_params
            if verbose:
                print(f"[ba-stage] ite={ite} stage2 cost "
                      f"{res.cost_initial:.4e} -> {res.cost_final:.4e}")

        # normalize (cc:271)
        R, t, xyz, _ = normalize_reconstruction(R, t, xyz)

        # 6.3 progressive filtering (cc:273-301): tighten until >0.1% of
        # tracks lose observations, then BA again. ``ite`` advances both in
        # the tightening loop (cc:296) and per outer round (the C++ for-loop
        # increment, cc:245)
        status = True
        filtered = 0
        while status and ite < num_iterations:
            scaling = max(3 - ite, 1)
            keep = filter_tracks_by_reprojection(
                edges(alive), features_undist[alive], R, t, xyz,
                scaling * max_reprojection_error)
            filtered += int((~keep).sum())
            alive[np.flatnonzero(alive)[~keep]] = False
            if filtered > 1e-3 * max(M, 1):
                status = False
            else:
                ite += 1
        if status:
            if verbose:
                print("[ba-stage] <0.1% tracks filtered; stopping")
            break
        ite += 1

    # final filters (cc:305-321)
    keep = filter_tracks_by_reprojection(
        edges(alive), features_undist[alive], R, t, xyz,
        max_reprojection_error)
    alive[np.flatnonzero(alive)[~keep]] = False
    keep, _ = filter_track_triangulation_angle(
        edges(alive), R, t, xyz, min_triangulation_angle)
    alive[np.flatnonzero(alive)[~keep]] = False
    return alive, R, t, xyz, cam_params


def _undistorted_rays(obs_xy, cam_params, obs_cam):
    """Pixels -> unit rays through the generic model (Newton inversion of
    the polynomial distortion, image_undistorter.cc semantics)."""
    cam_params = np.asarray(cam_params, dtype=np.float64)
    obs_cam = np.asarray(obs_cam, dtype=np.int64)
    p = cam_params[obs_cam]
    xy = (np.asarray(obs_xy, dtype=np.float64) - p[:, 2:4]) / p[:, :2]

    def fwd(u):
        x, y = u[:, 0], u[:, 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (p[:, 4] + r2 * p[:, 5])
        xd = x * radial + 2 * p[:, 6] * x * y + p[:, 7] * (r2 + 2 * x * x)
        yd = y * radial + p[:, 6] * (r2 + 2 * y * y) + 2 * p[:, 7] * x * y
        return np.stack([xd, yd], axis=1)

    u = xy.copy()
    for _ in range(50):
        err = fwd(u) - xy
        if np.max(np.abs(err)) < 1e-12:
            break
        eps = 1e-8
        jx = (fwd(u + [eps, 0.0]) - fwd(u)) / eps
        jy = (fwd(u + [0.0, eps]) - fwd(u)) / eps
        det = jx[:, 0] * jy[:, 1] - jy[:, 0] * jx[:, 1]
        det = np.where(np.abs(det) < 1e-30, 1e-30, det)
        du = (jy[:, 1] * err[:, 0] - jy[:, 0] * err[:, 1]) / det
        dv = (-jx[:, 1] * err[:, 0] + jx[:, 0] * err[:, 1]) / det
        u = u - np.stack([du, dv], axis=1)
    h = np.concatenate([u, np.ones((len(u), 1))], axis=1)
    return h / np.linalg.norm(h, axis=1, keepdims=True)


