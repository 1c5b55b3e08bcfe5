"""View-graph calibration: robust focal-length estimation from fundamental
matrices.

PyTorch counterpart of ``xmtpu/pipeline/calibration.py``, a re-design of the
reference's Ceres-based ``ViewGraphCalibrator``
(deps/glomap/glomap/estimators/view_graph_calibration.cc:12-186,
cost in deps/glomap/glomap/estimators/cost_function.h:44-199).
The reference builds one Ceres problem with two Fetzer focal-length residuals
per image pair, a Cauchy loss, and per-camera scalar focal parameters, then

* copies back focals whose ratio to the prior stays inside
  ``[thres_lower_ratio, thres_higher_ratio]`` (view_graph_calibration.cc:123-148),
* invalidates pairs whose *unweighted* residual exceeds
  ``thres_two_view_error`` (view_graph_calibration.cc:151-186).

Here the Fetzer coefficients for every pair are precomputed once (batched
numpy SVD), and the robust problem is solved with a damped IRLS
Gauss--Newton iteration in f64 torch on the given device (forward-mode
Jacobian by ``torch.func.jacfwd``, dense normal equations over the
per-camera focal vector — C is tiny), its accept/reject loop on the host as
in the reference. Cameras with prior focals are frozen exactly like
``SetParameterBlockConstant`` (view_graph_calibration.cc:106-121).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from xmtpu_torch._device import resolve_device


@dataclass
class CalibrationOptions:
    """Mirrors ViewGraphCalibratorOptions (view_graph_calibration.h:10-24)."""

    thres_lower_ratio: float = 0.1
    thres_higher_ratio: float = 10.0
    thres_two_view_error: float = 2.0
    # Ceres CauchyLoss scale `a` (OptimizationBaseOptions.thres_loss_function,
    # set to 1e-2 in the calibrator ctor): rho(s) = a^2 log(1 + s / a^2).
    loss_scale: float = 1e-2
    max_iterations: int = 100
    damping: float = 1e-6


def fetzer_coeffs(F: np.ndarray, pp0: np.ndarray, pp1: np.ndarray):
    """Per-pair Fetzer coefficient vectors (d01, d12).

    ``F`` is the (P, 3, 3) stack of fundamental matrices mapping image-0
    pixels to image-1 lines; ``pp0``/``pp1`` are (P, 2) principal points.
    Follows cost_function.h:47-100: G = K1^T F K0 with principal-point-only
    K, SVD of G, then the bilinear d-vectors for index pairs (1,0) and (2,1).
    """
    F = np.asarray(F, dtype=np.float64).reshape(-1, 3, 3)
    P = F.shape[0]
    K0 = np.tile(np.eye(3), (P, 1, 1))
    K1 = np.tile(np.eye(3), (P, 1, 1))
    K0[:, 0, 2] = pp0[:, 0]
    K0[:, 1, 2] = pp0[:, 1]
    K1[:, 0, 2] = pp1[:, 0]
    K1[:, 1, 2] = pp1[:, 1]
    G = np.transpose(K1, (0, 2, 1)) @ F @ K0

    U, S, Vt = np.linalg.svd(G)
    v0, v1 = Vt[:, 0, :], Vt[:, 1, :]
    u0, u1 = U[:, :, 0], U[:, :, 1]
    s0, s1 = S[:, 0], S[:, 1]

    ai = np.stack([
        s0 * s0 * (v0[:, 0] ** 2 + v0[:, 1] ** 2),
        s0 * s1 * (v0[:, 0] * v1[:, 0] + v0[:, 1] * v1[:, 1]),
        s1 * s1 * (v1[:, 0] ** 2 + v1[:, 1] ** 2),
    ], axis=1)
    aj = np.stack([
        u1[:, 0] ** 2 + u1[:, 1] ** 2,
        -(u0[:, 0] * u1[:, 0] + u0[:, 1] * u1[:, 1]),
        u0[:, 0] ** 2 + u0[:, 1] ** 2,
    ], axis=1)
    bi = np.stack([
        s0 * s0 * v0[:, 2] ** 2,
        s0 * s1 * v0[:, 2] * v1[:, 2],
        s1 * s1 * v1[:, 2] ** 2,
    ], axis=1)
    bj = np.stack([
        u1[:, 2] ** 2,
        -(u0[:, 2] * u1[:, 2]),
        u0[:, 2] ** 2,
    ], axis=1)

    def d_vec(u, v):
        return np.stack([
            ai[:, u] * aj[:, v] - ai[:, v] * aj[:, u],
            ai[:, u] * bj[:, v] - ai[:, v] * bj[:, u],
            bi[:, u] * aj[:, v] - bi[:, v] * aj[:, u],
            bi[:, u] * bj[:, v] - bi[:, v] * bj[:, u],
        ], axis=1)

    return d_vec(1, 0), d_vec(2, 1)


def _pair_residuals(focals, cam0, cam1, d01, d12):
    """Two Fetzer residuals per pair (cost_function.h:132-152)."""
    fi = focals[cam0]
    fj = focals[cam1]
    fi2 = fi * fi
    fj2 = fj * fj
    di = fj2 * d01[:, 0] + d01[:, 1]
    dj = fi2 * d12[:, 0] + d12[:, 2]
    di = torch.where(di == 0.0, 1e-6, di)
    dj = torch.where(dj == 0.0, 1e-6, dj)
    K0_01 = -(fj2 * d01[:, 2] + d01[:, 3]) / di
    K1_12 = -(fi2 * d12[:, 1] + d12[:, 3]) / dj
    r0 = (fi2 - K0_01) / fi2
    r1 = (fj2 - K1_12) / fj2
    return torch.stack([r0, r1], dim=1)  # (P, 2)


def calibrate_view_graph(F, cam0, cam1, principal_points, focals,
                         prior_mask=None, opts: CalibrationOptions = None,
                         device=None):
    """Estimate per-camera focal lengths from pairwise fundamental matrices.

    Args:
      F: (P, 3, 3) fundamental matrices (image0 -> image1 epipolar lines).
      cam0, cam1: (P,) int camera index of each pair's two images.
      principal_points: (C, 2) per camera.
      focals: (C,) initial (prior) focal lengths.
      prior_mask: (C,) bool; True = camera has a trusted prior focal and is
        held constant (view_graph_calibration.cc:114-117).
      opts: thresholds; defaults mirror the reference.
      device: where the Gauss--Newton iterations run (None = the CUDA card).

    Returns dict with ``focals`` (C,), ``refined`` (C,) bool (focal actually
    updated), ``pair_valid`` (P,) bool (two-view error below threshold), and
    ``residuals`` (P, 2), all numpy.
    """
    dev = resolve_device(device)
    opts = opts or CalibrationOptions()
    F = np.asarray(F, dtype=np.float64).reshape(-1, 3, 3)
    cam0 = np.asarray(cam0, dtype=np.int64)
    cam1 = np.asarray(cam1, dtype=np.int64)
    pp = np.asarray(principal_points, dtype=np.float64).reshape(-1, 2)
    focals0 = np.asarray(focals, dtype=np.float64).copy()
    C = focals0.shape[0]
    P = F.shape[0]
    if prior_mask is None:
        prior_mask = np.zeros(C, dtype=bool)
    prior_mask = np.asarray(prior_mask, dtype=bool)

    if P == 0 or bool(prior_mask.all()):
        return {"focals": focals0, "refined": np.zeros(C, dtype=bool),
                "pair_valid": np.ones(P, dtype=bool),
                "residuals": np.zeros((P, 2))}

    d01, d12 = fetzer_coeffs(F, pp[cam0], pp[cam1])
    d01_t = torch.as_tensor(d01, device=dev)
    d12_t = torch.as_tensor(d12, device=dev)
    cam0_t = torch.as_tensor(cam0, device=dev)
    cam1_t = torch.as_tensor(cam1, device=dev)
    free = torch.as_tensor(~prior_mask, dtype=torch.float64, device=dev)
    eye = torch.eye(C, dtype=torch.float64, device=dev)

    # Ceres CauchyLoss(a): rho(s) = b log(1 + s/b), b = a^2
    b2 = opts.loss_scale ** 2

    def residuals_of(f):
        return _pair_residuals(f, cam0_t, cam1_t, d01_t, d12_t)

    jac_fn = torch.func.jacfwd(lambda f: residuals_of(f).reshape(-1))

    f = torch.as_tensor(focals0, device=dev)
    lm = opts.damping
    prev_cost = None
    for _ in range(opts.max_iterations):
        r = residuals_of(f)                 # (P, 2)
        s = torch.sum(r * r, dim=1)         # per-pair squared norm
        w = 1.0 / (1.0 + s / b2)            # Cauchy IRLS weight rho'(s)
        cost = float(torch.sum(b2 * torch.log1p(s / b2)))
        J = jac_fn(f).reshape(P, 2, C)      # (P, 2, C)
        Jw = J * w[:, None, None]
        H = torch.einsum("pri,prj->ij", Jw, J)
        g = torch.einsum("pri,pr->i", Jw, r)
        # freeze prior cameras: zero their rows/cols, unit diagonal
        H = H * free[:, None] * free[None, :] + torch.diag(1.0 - free)
        g = g * free
        Hd = H + lm * torch.diag(torch.diag(H)) + 1e-12 * eye
        # where the factorization fails the reference's Cholesky returns NaN:
        # the step is NaN, the trial cost too, and the step is rejected
        L, info = torch.linalg.cholesky_ex(Hd)
        step = torch.cholesky_solve(g[:, None], L)[:, 0]
        step = torch.where(info == 0, step, torch.nan)
        f_new = torch.clamp_min(f - step, 1e-3)  # lower bound, cc:113
        r_new = residuals_of(f_new)
        s_new = torch.sum(r_new * r_new, dim=1)
        cost_new = float(torch.sum(b2 * torch.log1p(s_new / b2)))
        if cost_new < cost:
            f = f_new
            lm = max(lm * 0.3, 1e-12)
            if prev_cost is not None and abs(prev_cost - cost_new) \
                    <= 1e-12 * max(1.0, abs(prev_cost)):
                prev_cost = cost_new
                break
            prev_cost = cost_new
        else:
            lm *= 10.0
            if lm > 1e8:
                break

    f_est = f.cpu().numpy()
    ratio = f_est / focals0
    # reject degenerate estimates, keep the prior (cc:129-138)
    ok = ((ratio >= opts.thres_lower_ratio) &
          (ratio <= opts.thres_higher_ratio) & ~prior_mask)
    focals_out = np.where(ok, f_est, focals0)

    # pair filtering on the *final* unweighted residuals (cc:151-186)
    r_final = residuals_of(torch.as_tensor(focals_out, device=dev))
    r_final = r_final.cpu().numpy()
    err_sq = np.sum(r_final ** 2, axis=1)
    pair_valid = err_sq <= opts.thres_two_view_error ** 2

    return {"focals": focals_out, "refined": ok, "pair_valid": pair_valid,
            "residuals": r_final}


def fundamental_from_pose(K0, K1, R, t):
    """Exact F from a relative pose (R, t): x1 in image-1 of X expressed in
    camera-0 frame as x1 = K1 (R X + t). Utility for tests and synthetic
    view graphs: F = K1^{-T} [t]x R K0^{-1}."""
    K0 = np.asarray(K0, dtype=np.float64)
    K1 = np.asarray(K1, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64).reshape(3)
    tx = np.array([[0.0, -t[2], t[1]],
                   [t[2], 0.0, -t[0]],
                   [-t[1], t[0], 0.0]])
    E = tx @ np.asarray(R, dtype=np.float64)
    F = np.linalg.inv(K1).T @ E @ np.linalg.inv(K0)
    n = np.linalg.norm(F)
    return F / n if n > 0 else F
