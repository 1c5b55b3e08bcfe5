"""Gravity refinement: robust correction of per-image gravity directions.

Re-design of the reference GLOMAP fork's ``GravityRefiner``
(deps/glomap/glomap/estimators/gravity_refinement.cc:9-155;
cost deps/glomap/glomap/estimators/cost_function.h:218-243).
Like global positioning, the stage is compiled but disabled in XM's
truncated pipeline; xmtpu covers the capability.

Reference behavior replicated:

* error-prone detection (cc:100-155): for every valid pair where both images
  carry gravity, form the gravity-aligned relative rotation
  ``R = RAlign_j^T R_ij RAlign_i``, measure its angle to the closest
  upright (y-axis) rotation; an image is error-prone when it has at least
  ``min_num_neighbors`` gravity pairs and at least ``max_outlier_ratio`` of
  them exceed ``max_gravity_error`` degrees;
* per error-prone image (cc:28-98): neighbor-implied gravity observations
  ``(R_ij^T RAlign_j).col(1)`` / ``(R_ij RAlign_i).col(1)``, robustly
  averaged on the unit sphere — the Ceres ArctanLoss(1 - cos(max_err))
  on the squared chordal residual becomes an IRLS weight
  ``1 / (1 + (s/a)^2)`` — and the refined gravity is accepted only when the
  fraction of neighbors farther than ``2 * max_gravity_error`` drops below
  ``max_outlier_ratio`` (cc:82-93).

The port's copy of ``xmtpu/pipeline/gravity.py`` (numpy).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class GravityRefinerOptions:
    """Mirrors GravityRefinerOptions (gravity_refinement.h:12-24)."""

    max_outlier_ratio: float = 0.5
    max_gravity_error_deg: float = 1.0
    min_num_neighbors: int = 7
    irls_iters: int = 50


def gravity_to_ralign(g):
    """Rotation with column 1 equal to the gravity direction (the glomap
    GravityToRAlign convention: y-axis maps to gravity)."""
    g = np.asarray(g, dtype=np.float64)
    g = g / np.linalg.norm(g)
    a = np.array([1.0, 0.0, 0.0]) if abs(g[0]) < 0.9 else \
        np.array([0.0, 0.0, 1.0])
    x = np.cross(g, a)
    x /= np.linalg.norm(x)
    z = np.cross(x, g)
    return np.stack([x, g, z], axis=1)


def _upright_angle_deg(R):
    """Angle (deg) between R and the nearest rotation about the y axis.

    RotUpToAngle/AngleToRotUp + CalcAngle in glomap/math: the closest
    upright rotation has angle atan2(R02 - R20, R00 + R22)."""
    th = np.arctan2(R[..., 0, 2] - R[..., 2, 0], R[..., 0, 0] + R[..., 2, 2])
    c, s = np.cos(th), np.sin(th)
    zero = np.zeros_like(th)
    one = np.ones_like(th)
    R_up = np.stack([
        np.stack([c, zero, s], -1),
        np.stack([zero, one, zero], -1),
        np.stack([-s, zero, c], -1),
    ], axis=-2)
    tr = np.einsum("...ij,...ij->...", R_up, R)
    cosang = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(cosang))


def refine_gravity(pair_i, pair_j, R_rel, gravities, has_gravity=None,
                   opts: GravityRefinerOptions = None):
    """Refine per-image gravity directions against view-graph neighbors.

    Args:
      pair_i, pair_j: (P,) image indices of each valid pair.
      R_rel: (P, 3, 3) relative rotations (camera j from camera i).
      gravities: (N, 3) per-image gravity directions (camera frame).
      has_gravity: (N,) bool mask; default all True.

    Returns ``(gravities_out, refined_mask, error_prone_mask)``.
    """
    opts = opts or GravityRefinerOptions()
    pair_i = np.asarray(pair_i, int)
    pair_j = np.asarray(pair_j, int)
    R_rel = np.asarray(R_rel, dtype=np.float64).reshape(-1, 3, 3)
    G = np.asarray(gravities, dtype=np.float64).copy()
    N = G.shape[0]
    if has_gravity is None:
        has_gravity = np.ones(N, dtype=bool)
    has_gravity = np.asarray(has_gravity, dtype=bool)

    norms = np.linalg.norm(G, axis=1)
    G[has_gravity] /= norms[has_gravity, None]

    Ralign = np.stack([gravity_to_ralign(G[i]) if has_gravity[i] else np.eye(3)
                       for i in range(N)])

    both = has_gravity[pair_i] & has_gravity[pair_j]
    ii, jj, Rr = pair_i[both], pair_j[both], R_rel[both]

    # --- error-prone detection (cc:100-155)
    Raligned = (np.transpose(Ralign[jj], (0, 2, 1)) @ Rr @ Ralign[ii])
    ang = _upright_angle_deg(Raligned)
    bad = ang > opts.max_gravity_error_deg
    total = np.bincount(ii, minlength=N) + np.bincount(jj, minlength=N)
    mistakes = (np.bincount(ii, weights=bad, minlength=N) +
                np.bincount(jj, weights=bad, minlength=N))
    with np.errstate(invalid="ignore", divide="ignore"):
        prone = (has_gravity & (total >= opts.min_num_neighbors) &
                 (mistakes >= opts.max_outlier_ratio * np.maximum(total, 1)))

    refined = np.zeros(N, dtype=bool)
    a = 1.0 - np.cos(np.radians(opts.max_gravity_error_deg))  # ArctanLoss scale

    for img in np.nonzero(prone)[0]:
        sel_i = jj == img   # img is the pair's j: obs = (R_ij R_align_i).col(1)
        sel_j = ii == img   # img is the pair's i: obs = (R_ij^T R_align_j).col(1)
        obs = []
        if sel_j.any():
            obs.append((np.transpose(Rr[sel_j], (0, 2, 1)) @
                        Ralign[jj[sel_j]])[:, :, 1])
        if sel_i.any():
            obs.append((Rr[sel_i] @ Ralign[ii[sel_i]])[:, :, 1])
        if not obs:
            continue
        obs = np.concatenate(obs, axis=0)
        if len(obs) < opts.min_num_neighbors:
            continue

        g = G[img]
        for _ in range(opts.irls_iters):
            r2 = np.sum((g[None, :] - obs) ** 2, axis=1)
            w = 1.0 / (1.0 + (r2 / a) ** 2)      # ArctanLoss rho'(s)
            g_new = (w[:, None] * obs).sum(axis=0)
            n = np.linalg.norm(g_new)
            if n < 1e-12:
                break
            g_new /= n
            if np.linalg.norm(g_new - g) < 1e-14:
                g = g_new
                break
            g = g_new

        err = np.degrees(np.arccos(np.clip(obs @ g, -1.0, 1.0)))
        n_out = (err > 2.0 * opts.max_gravity_error_deg).sum()
        if n_out / len(obs) < opts.max_outlier_ratio:    # cc:89-93
            G[img] = g
            refined[img] = True

    return G, refined, prone
