"""Front-end adapters: GLOMAP tempdata parsing, view-graph construction,
depth lifting.

The perception front end (COLMAP feature matching, the GLOMAP fork's
view-graph construction, UniDepth monocular depth) is external tooling even in
the reference — invoked as subprocesses / site-packages
(3_test_colmap_glomap.py:85-136).  xmtpu provides the
adapters so every solver-side configuration runs from those tools' outputs
(or from the synthetic generator) without the heavy dependencies:

* :func:`parse_glomap_tempdata` — the three exported txt files written by the
  XM-modified GLOMAP (deps/glomap/glomap/controllers/global_mapper.cc:134-186):
  ``output.txt`` (``image_id u v track_idx`` per observation),
  ``filename.txt`` (``image_id name``), ``relative_pose.txt``
  (``id1 id2 qw qx qy qz tx ty tz``).
* :func:`build_view_graph` — dedupe observations and build the sparse
  bipartite structures (3_test:173-187).
* :func:`lift_depth` — lift 2-D features with per-pixel depth + confidence:
  ``x = K^-1 [u, v, 1]^T * d``, weight = confidence^2 (3_test:212-262).

The port's copy of ``xmtpu/pipeline/frontend.py`` (numpy; the port never
imports the JAX package, not even its numpy-only modules).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np


def quat2rot(qw: float, qx: float, qy: float, qz: float) -> np.ndarray:
    """Unit quaternion -> rotation matrix (utils/cameramath.py:3-8)."""
    q = np.array([qw, qx, qy, qz], dtype=np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class GlomapExport(NamedTuple):
    matches: np.ndarray    # (E, 4): image_id, u, v, track_idx (1-based ids)
    filenames: np.ndarray  # (N,) object array: image_id-1 -> name
    relposes: dict         # (id1, id2) -> (R, t) two-view poses
    N: int
    M: int


def parse_glomap_tempdata(tempdata_dir: str) -> GlomapExport:
    """Parse the XM-GLOMAP export directory (3_test:140-171)."""
    matches = np.loadtxt(os.path.join(tempdata_dir, "output.txt"))
    if matches.ndim == 1:
        matches = matches[None, :]

    filenames_raw = []
    with open(os.path.join(tempdata_dir, "filename.txt")) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                filenames_raw.append((int(parts[0]), parts[1]))
    filenames_raw.sort()
    max_index = max(i for i, _ in filenames_raw) if filenames_raw else 0
    filenames = np.empty(max_index, dtype=object)
    for i, name in filenames_raw:
        filenames[i - 1] = name

    relposes = {}
    rp_path = os.path.join(tempdata_dir, "relative_pose.txt")
    if os.path.exists(rp_path):
        relpose = np.loadtxt(rp_path)
        if relpose.ndim == 1 and relpose.size:
            relpose = relpose[None, :]
        for row in relpose:
            R = quat2rot(row[2], row[3], row[4], row[5])
            relposes[(int(row[0]), int(row[1]))] = (R, row[6:9])

    N = int(matches[:, 0].max())
    M = int(matches[:, 3].max())
    return GlomapExport(matches, filenames, relposes, N, M)


def tracks_from_feature_matches(image_ids1, feature_ids1, image_ids2,
                                feature_ids2):
    """Concatenate pairwise feature matches into landmark tracks — the
    GLOMAP TrackEstablishment stage
    (deps/glomap/glomap/controllers/track_establishment.{h,cc}).

    Observations are (image_id, feature_id) pairs; matched observations are
    merged by union-find (native C++ kernel when built).  Returns
    ``(obs_keys, track_ids)``: the unique observation keys
    ``image_id << 32 | feature_id`` and their track id (descending size
    order, matching GLOMAP's size-sorted tracks).
    """
    from xmtpu_torch.runtime import establish_tracks

    k1 = (np.asarray(image_ids1, np.int64) << 32) | np.asarray(feature_ids1, np.int64)
    k2 = (np.asarray(image_ids2, np.int64) << 32) | np.asarray(feature_ids2, np.int64)
    keys, inv = np.unique(np.concatenate([k1, k2]), return_inverse=True)
    a, b = inv[:len(k1)], inv[len(k1):]
    _, track_of = establish_tracks(a, b, len(keys))
    return keys, track_of


class ViewGraph(NamedTuple):
    frame: np.ndarray    # (E,) 0-based frame ids
    track: np.ndarray    # (E,) 0-based landmark/track ids
    u: np.ndarray        # (E,) pixel x
    v: np.ndarray        # (E,) pixel y
    N: int
    M: int


def build_view_graph(matches: np.ndarray, N: int | None = None,
                     M: int | None = None) -> ViewGraph:
    """Dedupe (frame, track) pairs and return flat observation arrays
    (3_test:173-187, without the scipy sparse detour)."""
    edges = matches[:, [0, 3]].astype(int)
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    edges = edges[order]
    matches = matches[order]
    _, uniq = np.unique(edges, axis=0, return_index=True)
    matches = matches[uniq]
    N = N or int(matches[:, 0].max())
    M = M or int(matches[:, 3].max())
    return ViewGraph(matches[:, 0].astype(int) - 1,
                     matches[:, 3].astype(int) - 1,
                     matches[:, 1], matches[:, 2], N, M)


def lift_depth(u, v, track, depth_map, confidence_map, K,
               border_margin: int = 0, depth_clip_pct: float | None = None):
    """Depth-lift one image's 2-D observations to camera-frame 3-D points.

    Mirrors the per-image loop body (3_test:219-252; margin/percentile
    clipping from 4_test_unidepth.py:234-245).  Returns
    ``(points (K,3), weights (K,), track_ids (K,))`` after validity filtering.
    """
    u = np.asarray(u).astype(int)
    v = np.asarray(v).astype(int)
    track = np.asarray(track)
    h, w = depth_map.shape
    ok = (u >= border_margin) & (u < w - border_margin) & \
         (v >= border_margin) & (v < h - border_margin)
    u, v, track = u[ok], v[ok], track[ok]
    d = depth_map[v, u]
    ok = d > 0
    if depth_clip_pct is not None and np.any(ok):
        ok &= d <= np.percentile(d[d > 0], depth_clip_pct)
    u, v, track, d = u[ok], v[ok], track[ok], d[ok]
    conf = confidence_map[v, u]
    pix = np.vstack([u, v, np.ones_like(u)]).astype(np.float64)
    cam = (np.linalg.inv(K) @ pix).T * d[:, None]
    return cam, conf**2, track


def lift_dataset(view_graph: ViewGraph, depth_for_frame, K_for_frame,
                 border_margin: int = 0, depth_clip_pct: float | None = None):
    """Lift every frame's observations.

    ``depth_for_frame(i) -> (depth_map, confidence_map)``;
    ``K_for_frame(i) -> (3,3)``.  Returns ``(edges (E,2) 1-based, weights,
    landmarks)`` ready for :func:`xmtpu_torch.pipeline.graph.checklandmarks`.
    """
    pts, wts, eds = [], [], []
    for i in range(view_graph.N):
        sel = view_graph.frame == i
        if not np.any(sel):
            continue
        depth, conf = depth_for_frame(i)
        cam, w, tr = lift_depth(view_graph.u[sel], view_graph.v[sel],
                                view_graph.track[sel], depth, conf,
                                K_for_frame(i), border_margin, depth_clip_pct)
        pts.append(cam)
        wts.append(w)
        eds.append(np.stack([np.full(len(tr), i), tr], axis=1))
    landmarks = np.concatenate(pts, axis=0)
    weights = np.concatenate(wts)
    edges = np.concatenate(eds, axis=0).astype(int) + 1
    return edges, weights, landmarks
