"""Reconstruction normalization: robust-bbox Sim(3) re-centering.

Vectorized re-design of GLOMAP's ``NormalizeReconstruction``
(deps/glomap/glomap/processors/reconstruction_normalizer.cc:5-73):
compute the robust (percentile-trimmed) bounding box and mean of the camera
centers, scale the scene so the box diagonal equals ``extent``, and translate
the trimmed mean to the origin. The transform is a gauge change only — it
does not alter the SBA objective up to global scale, but keeps recovered
scenes numerically well-conditioned for refinement and export.

The Sim(3) here acts as ``x' = scale * (x + translation_pre)`` i.e. the
reference's ``Sim3d(scale, I, -scale * mean)`` with translation applied
before scaling (reconstruction_normalizer.cc:50-60).

The port's copy of ``xmtpu/pipeline/normalize.py`` (numpy).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Sim3(NamedTuple):
    scale: float
    rotation: np.ndarray     # (3,3), identity for normalization
    translation: np.ndarray  # (3,), applied after scaling: x' = s R x + t

    def apply(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        return self.scale * (x @ self.rotation.T) + self.translation


def normalize_reconstruction(R, t, points=None, fixed_scale: bool = False,
                             extent: float = 10.0, p0: float = 0.1,
                             p1: float = 0.9, registered=None):
    """Normalize camera poses (and optionally points) in place-semantics.

    Args:
      R, t: (N,3,3)/(N,3) cam_from_world poses.
      points: optional (M,3) track positions to transform with the same Sim3.
      fixed_scale: keep scale 1 (reconstruction_normalizer.cc:53-58).
      extent, p0, p1: target bbox diagonal and trim percentiles
        (defaults mirror colmap::Reconstruction::Normalize).
      registered: optional (N,) bool mask — only registered images contribute
        to the statistics (cc:22) but all registered poses are transformed.

    Returns ``(R, t_new, points_new, tform)`` where ``tform`` is the
    :class:`Sim3`; rotations are untouched (the transform is rotation-free).
    """
    R = np.asarray(R, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    centers = -np.einsum("nba,nb->na", R, t)
    stat = centers if registered is None else centers[np.asarray(registered,
                                                                 dtype=bool)]
    n = stat.shape[0]
    if n == 0:
        raise ValueError("no registered images to normalize")

    # Robust per-axis bounding box: sort each coordinate independently
    # (reconstruction_normalizer.cc:30-40).
    coords = np.sort(stat, axis=0)
    if n > 3:
        P0 = int(p0 * (n - 1))
        P1 = int(p1 * (n - 1))
    else:
        P0, P1 = 0, n - 1
    bbox_min = coords[P0]
    bbox_max = coords[P1]
    mean_coord = coords[P0:P1 + 1].mean(axis=0)

    scale = 1.0
    if not fixed_scale:
        old_extent = float(np.linalg.norm(bbox_max - bbox_min))
        if old_extent >= np.finfo(np.float64).eps:
            scale = extent / old_extent

    tform = Sim3(scale, np.eye(3), -scale * mean_coord)

    # cam_from_world' = cam_from_world ∘ tform^{-1}: rotation unchanged,
    # t' = s t - R tform.t  (TransformCameraWorld for identity rotation).
    t_new = scale * t + np.einsum("nab,b->na", R, -tform.translation)
    pts_new = None if points is None else tform.apply(points)
    return R, t_new, pts_new, tform
