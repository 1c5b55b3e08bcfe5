"""View-graph processors: pair inlier counting and relative-pose filters.

Vectorized re-designs of the GLOMAP processors that run in the reference's
*active* (truncated) pipeline stages
(deps/glomap/glomap/controllers/global_mapper.cc:49-111):

* ``ImagePairsInlierCount`` -> :func:`pair_inliers` — Sampson epipolar error
  of undistorted bearings against the two-view essential matrix, with the
  cheirality and degeneracy (small-triangulation-angle / near-epipole)
  checks of ``ScoreErrorEssential``
  (processors/image_pair_inliers.cc:20-92, math/two_view_geometry.cc:5-29,
  71-83), done as one numpy pass over all matches of a pair instead of a
  scalar loop;
* ``RelPoseFilter::FilterInlierNum`` / ``FilterInlierRatio`` ->
  :func:`filter_pairs_by_inliers` (processors/relpose_filter.h:15-22,
  defaults from glomap/types.h:25-31);
* ``RelPoseFilter::FilterRotations`` lives in
  :func:`xmtpu_torch.pipeline.rotation_averaging.filter_pairs`.

The port's copy of ``xmtpu/pipeline/viewgraph.py`` (numpy; the port never
imports the JAX package, not even its numpy-only modules).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class InlierThresholds:
    """Mirrors glomap InlierThresholdOptions (types.h:18-33)."""

    max_epipolar_error_E: float = 1.0   # pixels
    min_inlier_num: int = 30
    min_inlier_ratio: float = 0.25
    min_depth: float = 1e-2             # cheirality bounds (cc:65)
    max_depth: float = 100.0
    max_epipole_angle_deg: float = 3.0  # near-epipole degeneracy (cc:54)


def essential_from_motion(R, t):
    """E = [t]x R for the cam2-from-cam1 motion (math/two_view_geometry)."""
    t = np.asarray(t, dtype=np.float64).reshape(3)
    tx = np.array([[0.0, -t[2], t[1]],
                   [t[2], 0.0, -t[0]],
                   [-t[1], t[0], 0.0]])
    return tx @ np.asarray(R, dtype=np.float64)


def sampson_error(E, x1, x2):
    """Squared Sampson error for bearing vectors (two_view_geometry.cc:71-83:
    homogeneous normalization by the z components)."""
    x1 = np.asarray(x1, dtype=np.float64).reshape(-1, 3)
    x2 = np.asarray(x2, dtype=np.float64).reshape(-1, 3)
    eps = 1e-12
    Ex1 = (x1 / (x1[:, 2:3] + eps)) @ E.T
    Etx2 = (x2 / (x2[:, 2:3] + eps)) @ E
    C = np.sum(Ex1 * (x2 / (x2[:, 2:3] + eps)), axis=1)
    denom = (Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 +
             Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2)
    return C * C / np.maximum(denom, eps)


def check_cheirality(R, t, x1, x2, min_depth=1e-2, max_depth=100.0):
    """Two-ray depth-positivity test on unit bearings
    (two_view_geometry.cc:5-29, vectorized)."""
    x1 = np.asarray(x1, dtype=np.float64).reshape(-1, 3)
    x2 = np.asarray(x2, dtype=np.float64).reshape(-1, 3)
    t = np.asarray(t, dtype=np.float64).reshape(3)
    Rx1 = x1 @ np.asarray(R, dtype=np.float64).T
    a = -np.sum(Rx1 * x2, axis=1)
    b1 = -Rx1 @ t
    b2 = x2 @ t
    lam1 = b1 - a * b2
    lam2 = -a * b1 + b2
    lo = min_depth * (1.0 - a * a)
    hi = max_depth * (1.0 - a * a)
    return (lam1 > lo) & (lam2 > lo) & (lam1 < hi) & (lam2 < hi)


def pair_inliers(R, t, b1, b2, focal1, focal2,
                 opts: InlierThresholds = None):
    """Inlier mask + GC-RANSAC-style score for one image pair.

    Args:
      R, t: cam2_from_cam1 relative pose.
      b1, b2: (K, 3) unit bearings of the matched features (undistorted).
      focal1, focal2: camera focals — the pixel threshold converts to
        normalized space as ``thres_px * 0.5 * (1/f1 + 1/f2)``
        (image_pair_inliers.cc:42-44).

    Returns ``(inlier_mask, score)``.
    """
    opts = opts or InlierThresholds()
    E = essential_from_motion(R, t)
    t = np.asarray(t, dtype=np.float64).reshape(3)

    thres = opts.max_epipolar_error_E * 0.5 * (1.0 / focal1 + 1.0 / focal2)
    sq_threshold = thres * thres

    r2 = sampson_error(E, b1, b2)
    within = r2 < sq_threshold

    cheir = check_cheirality(R, t, b1, b2, opts.min_depth, opts.max_depth)

    # degeneracy: rays near-parallel or near the epipoles (cc:54-79)
    Rinv = np.asarray(R, dtype=np.float64).T
    thres_angle = 1.0 + 1e-6
    thres_epipole = np.cos(np.radians(opts.max_epipole_angle_deg)) + 1e-6
    b1a = np.asarray(b1, dtype=np.float64).reshape(-1, 3)
    b2a = np.asarray(b2, dtype=np.float64).reshape(-1, 3)
    diff_angle = np.sum(b1a * (b2a @ Rinv.T), axis=1)
    epi12 = t if t[2] >= 0 else -t
    t21 = -(Rinv @ t)
    epi21 = t21 if t21[2] >= 0 else -t21
    ok_angle = diff_angle < thres_angle
    ok_epi = (b1a @ epi21 < thres_epipole) & (b2a @ epi12 < thres_epipole)

    inliers = within & cheir & ok_angle & ok_epi
    score = np.where(inliers, r2, sq_threshold).sum()
    return inliers, float(score)


def filter_pairs_by_inliers(inlier_counts, match_counts,
                            opts: InlierThresholds = None):
    """FilterInlierNum + FilterInlierRatio (relpose_filter.h:15-22):
    keep pairs with >= min_inlier_num inliers AND inlier ratio >=
    min_inlier_ratio. Returns the keep mask."""
    opts = opts or InlierThresholds()
    inlier_counts = np.asarray(inlier_counts, dtype=np.float64)
    match_counts = np.asarray(match_counts, dtype=np.float64)
    ratio = inlier_counts / np.maximum(match_counts, 1.0)
    return ((inlier_counts >= opts.min_inlier_num) &
            (ratio >= opts.min_inlier_ratio))
