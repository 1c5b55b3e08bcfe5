"""Image front end: feature extraction, matching, two-view geometry, tracks.

The reference delegates this stage to external COLMAP (pycolmap
``extract_features`` / ``match_exhaustive``) and its vendored GLOMAP fork
(relative-pose estimation with poselib, track establishment) —
3_test_colmap_glomap.py:85-136.  xmtpu ships a self-contained
OpenCV-based equivalent so the complete images -> poses pipeline runs without
external binaries:

* :func:`extract_features` — SIFT keypoints/descriptors per image;
* :func:`match_pair` / :func:`match_exhaustive` — ratio-test + cross-check
  descriptor matching;
* :func:`two_view_geometry` — essential-matrix RANSAC + pose recovery (the
  GLOMAP relpose_estimation stage, usable by the relpose filter and by
  rotation averaging);
* :func:`build_tracks` — merge pairwise matches into landmark tracks via the
  native union-find (GLOMAP TrackEstablishment equivalent);
* :func:`run_frontend` — images + per-frame depth -> ``(edges, weights,
  landmarks)`` ready for the solver pipeline.

Depth comes from the caller (GT maps, a monocular network, RGB-D) exactly as
in the reference, where UniDepth/GT depth is a separate stage.

The port's copy of ``xmtpu/pipeline/features.py``: OpenCV and numpy on the
host, as in the reference; the focal calibration stage
(:func:`calibrate_from_matches`) runs the port's torch
``calibrate_view_graph`` on ``device`` (None = the CUDA card; raises without
one unless ``"cpu"``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

try:
    import cv2
    _HAS_CV2 = True
except ImportError:
    cv2 = None
    _HAS_CV2 = False

from xmtpu_torch._device import resolve_device
from xmtpu_torch.pipeline.frontend import (lift_depth,
                                           tracks_from_feature_matches)


class ImageFeatures(NamedTuple):
    keypoints: np.ndarray    # (K, 2) pixel positions
    descriptors: np.ndarray  # (K, D)


def extract_features(image, max_features: int = 4096) -> ImageFeatures:
    """SIFT features for one image (grayscale or BGR array)."""
    if not _HAS_CV2:
        raise RuntimeError("OpenCV not available")
    if image.ndim == 3:
        image = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
    sift = cv2.SIFT_create(nfeatures=max_features)
    kps, desc = sift.detectAndCompute(image, None)
    if desc is None:
        return ImageFeatures(np.zeros((0, 2)), np.zeros((0, 128), np.float32))
    pts = np.array([k.pt for k in kps])
    return ImageFeatures(pts, desc)


def match_pair(fa: ImageFeatures, fb: ImageFeatures, ratio: float = 0.8):
    """Lowe ratio-test matching with cross-check.  Returns (Ka,) -> index
    pairs (ia, ib) arrays."""
    if len(fa.descriptors) == 0 or len(fb.descriptors) == 0:
        return np.zeros((0, 2), int)
    bf = cv2.BFMatcher(cv2.NORM_L2)
    m_ab = bf.knnMatch(fa.descriptors, fb.descriptors, k=2)
    good_ab = {m[0].queryIdx: m[0].trainIdx for m in m_ab
               if len(m) == 2 and m[0].distance < ratio * m[1].distance}
    m_ba = bf.knnMatch(fb.descriptors, fa.descriptors, k=2)
    good_ba = {m[0].queryIdx: m[0].trainIdx for m in m_ba
               if len(m) == 2 and m[0].distance < ratio * m[1].distance}
    pairs = [(ia, ib) for ia, ib in good_ab.items()
             if good_ba.get(ib, -1) == ia]
    return np.asarray(pairs, int).reshape(-1, 2)


def two_view_geometry(pts_a, pts_b, K, ransac_thresh_px: float = 1.5):
    """Essential-matrix RANSAC + cheirality pose recovery.

    Returns ``(R, t, inlier_mask)`` with ``x_b ~ R x_a + t`` up to scale —
    the GLOMAP relative-pose convention — or ``(None, None, None)`` when
    degenerate.
    """
    if len(pts_a) < 8:
        return None, None, None
    E, mask = cv2.findEssentialMat(pts_a, pts_b, K, method=cv2.RANSAC,
                                   prob=0.999, threshold=ransac_thresh_px)
    if E is None or E.shape != (3, 3):
        return None, None, None
    _, R, t, mask_pose = cv2.recoverPose(E, pts_a, pts_b, K, mask=mask)
    return R, t.ravel(), (mask_pose.ravel() > 0)


def two_view_fundamental(pts_a, pts_b, ransac_thresh_px: float = 1.5):
    """Uncalibrated two-view geometry: fundamental matrix + inlier mask.

    The GLOMAP flow estimates pairwise geometry before intrinsics are
    trusted; the F matrices feed view-graph calibration
    (deps/glomap/glomap/estimators/view_graph_calibration.cc:68-104).
    Uses OpenCV RANSAC when available, else a normalized 8-point fit.
    """
    pts_a = np.asarray(pts_a, dtype=np.float64)
    pts_b = np.asarray(pts_b, dtype=np.float64)
    if len(pts_a) < 8:
        return None, None
    if _HAS_CV2:
        F, mask = cv2.findFundamentalMat(pts_a, pts_b, cv2.FM_RANSAC,
                                         ransac_thresh_px, 0.999)
        if F is None or F.shape != (3, 3):
            return None, None
        return F, mask.ravel() > 0
    # normalized 8-point (Hartley) without RANSAC
    def normalize(p):
        c = p.mean(axis=0)
        s = np.sqrt(2.0) / max(np.mean(np.linalg.norm(p - c, axis=1)), 1e-12)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])
        ph = np.concatenate([p, np.ones((len(p), 1))], axis=1) @ T.T
        return ph, T
    pa, Ta = normalize(pts_a)
    pb, Tb = normalize(pts_b)
    A = np.einsum("ni,nj->nij", pb, pa).reshape(len(pa), 9)
    _, _, vt = np.linalg.svd(A)
    F = vt[-1].reshape(3, 3)
    u, s, v = np.linalg.svd(F)
    F = u @ np.diag([s[0], s[1], 0.0]) @ v
    F = Tb.T @ F @ Ta
    F /= max(np.linalg.norm(F), 1e-12)
    return F, np.ones(len(pts_a), dtype=bool)


def calibrate_from_matches(features: list[ImageFeatures], matches,
                           principal_point, focal_init: float,
                           opts=None, device=None):
    """Fetzer focal calibration over matched pairs (single shared camera).

    ``matches`` is the list of ``(i, j, pairs)`` from
    :func:`match_exhaustive`. Returns ``(focal, pair_valid_mask)`` — the
    GLOMAP view-graph-calibration stage for the common one-camera capture
    (view_graph_calibration.cc:12-49 with
    FetzerFocalLengthSameCameraCost, cost_function.h:161-199), on
    ``device`` (None = the CUDA card).
    """
    from xmtpu_torch.pipeline.calibration import calibrate_view_graph

    device = resolve_device(device)
    Fs, keep = [], []
    for k, (i, j, pairs) in enumerate(matches):
        pa = features[i].keypoints[pairs[:, 0]]
        pb = features[j].keypoints[pairs[:, 1]]
        F, inl = two_view_fundamental(pa, pb)
        if F is None or inl.sum() < 8:
            continue
        Fs.append(F)
        keep.append(k)
    if not Fs:
        return focal_init, np.ones(len(matches), dtype=bool)
    P = len(Fs)
    out = calibrate_view_graph(
        np.array(Fs), np.zeros(P, int), np.zeros(P, int),
        np.asarray(principal_point, dtype=np.float64).reshape(1, 2),
        np.array([float(focal_init)]), opts=opts, device=device)
    pair_valid = np.ones(len(matches), dtype=bool)
    pair_valid[np.asarray(keep, int)] = out["pair_valid"]
    return float(out["focals"][0]), pair_valid


def match_exhaustive(features: list[ImageFeatures], K=None,
                     min_inliers: int = 15, verify: bool = True):
    """All-pairs matching (pycolmap.match_exhaustive equivalent).

    Returns ``(matches, relposes)``: matches is a list of (i, j, pairs) with
    geometrically verified correspondences; relposes maps 1-based (i+1, j+1)
    to (R, t) two-view poses when ``verify`` and K are given.
    """
    out = []
    relposes = {}
    n = len(features)
    for i in range(n):
        for j in range(i + 1, n):
            pairs = match_pair(features[i], features[j])
            if len(pairs) < min_inliers:
                continue
            if verify and K is not None:
                pa = features[i].keypoints[pairs[:, 0]]
                pb = features[j].keypoints[pairs[:, 1]]
                R, t, inl = two_view_geometry(pa, pb, K)
                if R is None or inl.sum() < min_inliers:
                    continue
                pairs = pairs[inl]
                relposes[(i + 1, j + 1)] = (R, t)
            out.append((i, j, pairs))
    return out, relposes


def build_tracks(matches, n_images: int):
    """Merge pairwise feature matches into tracks.

    Returns ``(obs_image, obs_feature_xy_index, track_id)`` triples flattened
    over unique observations: arrays ``(image_idx, feature_idx, track)``.
    """
    im1, f1, im2, f2 = [], [], [], []
    for (i, j, pairs) in matches:
        im1.extend([i] * len(pairs))
        f1.extend(pairs[:, 0].tolist())
        im2.extend([j] * len(pairs))
        f2.extend(pairs[:, 1].tolist())
    keys, tracks = tracks_from_feature_matches(im1, f1, im2, f2)
    images = (keys >> 32).astype(int)
    feats = (keys & 0xFFFFFFFF).astype(int)
    return images, feats, tracks


def run_frontend(images: list, K: np.ndarray,
                 depth_for_frame: "Callable[[int], tuple] | None" = None,
                 min_track_frames: int = 2, max_features: int = 4096,
                 border_margin: int = 0, depth_clip_pct: float | None = None,
                 refine_focal: bool = False, depth_model=None,
                 device=None):
    """images + intrinsics + depth -> ``(edges (E,2) 1-based, weights,
    landmarks, relposes)`` for the solver pipeline.

    Depth enters one of two ways: ``depth_for_frame(i) -> (depth, conf)``
    (precomputed maps — the GT-depth flow of 3_test_colmap_glomap.py), or
    ``depth_model`` — anything implementing ``infer(rgb) -> (depth, conf)``
    or a bare callable (the learned-depth flow of
    4_test_unidepth.py:202-224; see xmtpu_torch.pipeline.depth).

    ``refine_focal=True`` runs the view-graph-calibration stage first
    (Fetzer focal from pairwise fundamental matrices, as GLOMAP stage 1)
    on ``device`` (None = the CUDA card; raises without one unless
    ``"cpu"``) and replaces K's focal before geometric verification and
    lifting."""
    device = resolve_device(device)
    if depth_for_frame is None:
        if depth_model is None:
            raise ValueError("pass depth_for_frame or depth_model")
        from xmtpu_torch.pipeline.depth import depth_for_frames

        depth_for_frame = depth_for_frames(depth_model, images)
    feats = [extract_features(im, max_features) for im in images]
    K = np.asarray(K, dtype=np.float64)
    if refine_focal:
        matches_raw, _ = match_exhaustive(feats, None, verify=False)
        f, _ = calibrate_from_matches(feats, matches_raw, K[:2, 2],
                                      0.5 * (K[0, 0] + K[1, 1]),
                                      device=device)
        K = K.copy()
        K[0, 0] = K[1, 1] = f
    matches, relposes = match_exhaustive(feats, K)
    images_idx, feat_idx, tracks = build_tracks(matches, len(images))

    # keep tracks seen in >= min_track_frames
    counts = np.bincount(tracks)
    keep = counts[tracks] >= min_track_frames
    images_idx, feat_idx, tracks = (images_idx[keep], feat_idx[keep],
                                    tracks[keep])

    pts_list, w_list, edge_list = [], [], []
    for i in range(len(images)):
        sel = images_idx == i
        if not sel.any():
            continue
        kp = feats[i].keypoints[feat_idx[sel]]
        depth, conf = depth_for_frame(i)
        cam, w, tr = lift_depth(kp[:, 0], kp[:, 1], tracks[sel], depth, conf,
                                K, border_margin, depth_clip_pct)
        pts_list.append(cam)
        w_list.append(w)
        edge_list.append(np.stack([np.full(len(tr), i), tr], axis=1))
    landmarks = np.concatenate(pts_list, axis=0)
    weights = np.concatenate(w_list)
    edges = np.concatenate(edge_list, axis=0).astype(int) + 1
    return edges, weights, landmarks, relposes
