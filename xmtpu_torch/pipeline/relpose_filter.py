"""Pairwise relative-pose outlier filter (the "GLOMAP filter" of 5_test_ceres.py).

The port's copy of ``xmtpu/pipeline/relpose_filter.py`` (numpy and
``scipy.stats.trim_mean`` on the host, as in the reference; the port never
imports the JAX package, not even its numpy-only modules).

Re-design of the observation filter in
5_test_ceres.py:316-436: for every image pair with a GLOMAP
two-view pose and >= 20 shared landmarks, robustly align the two cameras'
lifted 3-D observations of the shared landmarks using the known relative
rotation (trimmed scale + trimmed translation), flag shared observations
whose relative alignment error exceeds ``max(3 * median, 95th percentile)``,
accumulate per-(frame, landmark) outlier votes, and finally delete every
flagged observation.

The per-pair work is vectorized (the intersection bookkeeping uses per-frame
hash maps; the alignment math is batched numpy).
"""

from __future__ import annotations

import itertools

import numpy as np
from scipy.stats import trim_mean


def relpose_filter(edges, weights, landmarks, rgbs, relposes,
                   min_shared: int = 20, verbose: bool = True):
    """Filter observations using two-view relative poses.

    Args:
      edges: (E, 2) 1-based [frame, landmark].
      relposes: dict ``(id1, id2) -> (R, t)`` with 1-based frame ids (the
        GLOMAP export convention;
        ``xmtpu_torch.pipeline.frontend.parse_glomap_tempdata``).

    Returns filtered ``(edges, weights, landmarks, rgbs)``.
    """
    edges = np.asarray(edges)
    weights = np.asarray(weights)
    landmarks = np.asarray(landmarks)
    rgbs = np.asarray(rgbs)
    N = int(edges[:, 0].max())
    M = int(edges[:, 1].max())

    # per-frame landmark -> observation row index
    obs_of = [dict() for _ in range(N)]
    for e, (fr, lm) in enumerate(edges):
        obs_of[fr - 1][lm - 1] = e

    error_sum = {}
    is_outlier = np.zeros(len(edges), dtype=bool)

    for (i, j) in itertools.combinations(range(N), 2):
        R, _t = relposes.get((i + 1, j + 1), (None, None))
        if R is None:
            continue
        shared = obs_of[i].keys() & obs_of[j].keys()
        if len(shared) < min_shared:
            continue
        shared = np.fromiter(shared, dtype=int)
        ei = np.array([obs_of[i][s] for s in shared])
        ej = np.array([obs_of[j][s] for s in shared])
        src = landmarks[ei].T    # camera-i frame points
        dst = landmarks[ej].T    # camera-j frame points

        # trimmed scale (5_test:327-347)
        dst_avg = trim_mean(dst, proportiontocut=0.05, axis=1)
        src_avg = trim_mean(src, proportiontocut=0.05, axis=1)
        dst_dis = np.linalg.norm(dst - dst_avg[:, None], axis=0)
        src_dis = np.linalg.norm(src - src_avg[:, None], axis=0)
        keep = (src_dis < np.percentile(src_dis, 90)) & \
               (dst_dis < np.percentile(dst_dis, 90))
        src_n, dst_n = src[:, keep], dst[:, keep]
        if src_n.shape[1] < 4:
            continue
        dst_avg = trim_mean(dst_n, proportiontocut=0.05, axis=1)
        src_avg = trim_mean(src_n, proportiontocut=0.05, axis=1)
        scale1 = trim_mean(np.linalg.norm(dst_n - dst_avg[:, None], axis=0),
                           proportiontocut=0.05)
        scale2 = trim_mean(np.linalg.norm(src_n - src_avg[:, None], axis=0),
                           proportiontocut=0.05)
        if scale2 == 0 or scale1 == 0:
            continue

        src_s = src / scale2 * scale1
        src_noR = R @ src_s
        translation = trim_mean(dst - src_noR, proportiontocut=0.05, axis=1)
        target = src_noR + translation[:, None]

        error = np.linalg.norm(target - dst, axis=0) / scale1
        threshold = 3 * np.median(error)
        outliers = error - max(threshold, np.percentile(error, 95)) > 0
        for s in shared[outliers]:
            error_sum[(i, s)] = error_sum.get((i, s), 0) + 1
            error_sum[(j, s)] = error_sum.get((j, s), 0) + 1

    # delete every flagged observation (5_test:419-426: all frames with a
    # positive vote on a landmark are removed)
    for (fr, lm) in error_sum:
        is_outlier[obs_of[fr][lm]] = True

    if verbose:
        print("Total remain observations after relpose filter:",
              int((~is_outlier).sum()))
        print("Total delete observations after relpose filter:",
              int(is_outlier.sum()))

    keep = ~is_outlier
    return edges[keep], weights[keep], landmarks[keep], rgbs[keep]
