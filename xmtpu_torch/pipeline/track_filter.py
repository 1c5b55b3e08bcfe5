"""Track filters: reprojection / angle / triangulation-angle observation cuts.

Vectorized re-design of the GLOMAP ``TrackFilter`` processor
(deps/glomap/glomap/processors/track_filter.cc). The
reference iterates tracks and observations in nested host loops; here every
filter is a single numpy pass over the flat observation arrays that the rest
of xmtpu already uses (``edges[k] = (frame i, track j)``).
The port's copy of ``xmtpu/pipeline/track_filter.py`` (numpy).

* ``FilterTracksByReprojection`` (track_filter.cc:7-51) ->
  :func:`filter_tracks_by_reprojection`
* ``FilterTracksByAngle`` (track_filter.cc:53-89) ->
  :func:`filter_tracks_by_angle`
* ``FilterTrackTriangulationAngle`` (track_filter.cc:91-126) ->
  :func:`filter_track_triangulation_angle`

All filters return a boolean *keep* mask over observations (the reference
mutates ``track.observations`` in place; callers here apply the mask with
``edges[keep]`` etc.). ``EPS`` matches glomap/scene/types.h.
"""

from __future__ import annotations

import numpy as np

EPS = 1e-12


def _cam_points(edges, R, t, xyz):
    """pt_calc = cam_from_world * track.xyz per observation
    (track_filter.cc:19)."""
    edges = np.asarray(edges)
    i = edges[:, 0]
    j = edges[:, 1]
    Ri = np.asarray(R, dtype=np.float64)[i]          # (E, 3, 3)
    ti = np.asarray(t, dtype=np.float64)[i]          # (E, 3)
    X = np.asarray(xyz, dtype=np.float64)[j]         # (E, 3)
    return np.einsum("eab,eb->ea", Ri, X) + ti


def filter_tracks_by_reprojection(edges, features, R, t, xyz,
                                  max_reprojection_error: float,
                                  cameras=None, camera_of_frame=None,
                                  in_normalized_image: bool = True):
    """Keep observations whose reprojection error is below the threshold.

    Parity with ``TrackFilter::FilterTracksByReprojection``
    (track_filter.cc:7-51).

    Args:
      edges: (E, 2) int (frame index, track index) per observation.
      features: (E, 3) undistorted feature rays (``features_undist``) when
        ``in_normalized_image`` (cc:23-30), else (E, 2) raw pixel keypoints
        compared after distorting the reprojection through the camera model
        (cc:31-36).
      R, t: (N,3,3)/(N,3) cam_from_world poses.
      xyz: (M, 3) track positions.
      max_reprojection_error: threshold; normalized-image units or pixels.
      cameras / camera_of_frame: required for the pixel-space branch —
        mapping frame -> :class:`xmtpu_torch.pipeline.undistort.Camera`.

    Returns:
      keep: (E,) bool. Behind-camera observations (depth < EPS) are dropped
      (cc:20 ``continue`` skips the keep-append).
    """
    pt = _cam_points(edges, R, t, xyz)
    z = pt[:, 2]
    in_front = z >= EPS
    zs = np.where(in_front, z, 1.0)
    reproj = pt[:, :2] / zs[:, None]

    feats = np.asarray(features, dtype=np.float64)
    if in_normalized_image:
        # compare against feature_undist de-homogenized (cc:27-30)
        fu = feats.reshape(-1, 3)
        target = fu[:, :2] / (fu[:, 2:3] + EPS)
        err = np.linalg.norm(reproj - target, axis=1)
    else:
        from .undistort import distort

        if cameras is None or camera_of_frame is None:
            raise ValueError("pixel-space filtering needs cameras")
        cam_ids = np.asarray(camera_of_frame)
        obs_cam = cam_ids[np.asarray(edges)[:, 0]]
        err = np.empty(len(pt))
        for cid in np.unique(obs_cam):
            sel = np.flatnonzero(obs_cam == cid)
            cam = cameras[int(cid)]
            uv = distort(cam, reproj[sel])
            err[sel] = np.linalg.norm(uv - feats[sel, :2], axis=1)

    return in_front & (err < max_reprojection_error)


def filter_tracks_by_angle(edges, bearings, R, t, xyz,
                           max_angle_error_deg: float,
                           has_prior_focal=None):
    """Keep observations whose ray-vs-feature angle is small.

    Parity with ``TrackFilter::FilterTracksByAngle`` (track_filter.cc:53-89):
    threshold ``cos(max_angle)`` for cameras with a prior focal length and
    ``cos(2 * max_angle)`` for uncalibrated ones (cc:60-61,73-75).

    Args:
      bearings: (E, 3) unit feature bearings (``features_undist``).
      has_prior_focal: (N,) bool per frame; default all True.
    """
    pt = _cam_points(edges, R, t, xyz)
    z = pt[:, 2]
    in_front = z >= EPS
    norm = np.linalg.norm(pt, axis=1, keepdims=True)
    pt_n = pt / np.maximum(norm, EPS)

    thres = np.cos(np.radians(max_angle_error_deg))
    thres_uncalib = np.cos(np.radians(2.0 * max_angle_error_deg))
    frames = np.asarray(edges)[:, 0]
    if has_prior_focal is None:
        thres_cam = np.full(len(pt), thres)
    else:
        hp = np.asarray(has_prior_focal, dtype=bool)[frames]
        thres_cam = np.where(hp, thres, thres_uncalib)

    b = np.asarray(bearings, dtype=np.float64).reshape(-1, 3)
    dots = np.sum(pt_n * b, axis=1)
    return in_front & (dots > thres_cam)


def filter_track_triangulation_angle(edges, R, t, xyz,
                                     min_angle_deg: float):
    """Drop whole tracks whose maximum pairwise triangulation angle is below
    ``min_angle_deg``.

    Parity with ``TrackFilter::FilterTrackTriangulationAngle``
    (track_filter.cc:91-126): per track, rays ``(xyz - center_i)`` are
    compared pairwise; the track survives iff some pair has
    ``dot < cos(min_angle)`` (cc:108-115), otherwise all its observations
    are cleared (cc:118-121).

    Returns ``(keep_obs, keep_track)``: per-observation and per-track masks.
    Tracks are processed in padded same-size batches so the quadratic pair
    check is one einsum per distinct track length instead of the reference's
    scalar double loop.
    """
    edges = np.asarray(edges)
    M = int(np.asarray(xyz).shape[0])
    centers = -np.einsum("nba,nb->na", np.asarray(R, dtype=np.float64),
                         np.asarray(t, dtype=np.float64))
    rays = np.asarray(xyz, dtype=np.float64)[edges[:, 1]] - centers[edges[:, 0]]
    rays /= np.maximum(np.linalg.norm(rays, axis=1, keepdims=True), EPS)

    thres = np.cos(np.radians(min_angle_deg))

    order = np.argsort(edges[:, 1], kind="stable")
    tj = edges[order, 1]
    uniq, starts, counts = np.unique(tj, return_index=True,
                                     return_counts=True)

    keep_track = np.zeros(M, dtype=bool)
    # tracks with < 2 observations can never pass (no pair exists)
    for k in np.unique(counts):
        if k < 2:
            continue
        sel = np.flatnonzero(counts == k)
        idx = starts[sel][:, None] + np.arange(k)[None, :]
        V = rays[order[idx]]                        # (B, k, 3)
        G = np.einsum("bia,bja->bij", V, V)         # pairwise dots
        iu = np.triu_indices(k, 1)
        good = (G[:, iu[0], iu[1]] < thres).any(axis=1)
        keep_track[uniq[sel]] = good

    keep_obs = keep_track[edges[:, 1]]
    return keep_obs, keep_track
