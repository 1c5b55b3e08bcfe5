"""COLMAP text-model export and gravity file I/O.

Parity with the GLOMAP export path
(deps/glomap/glomap/io/colmap_io.cc —
``WriteGlomapReconstruction`` converts to a colmap::Reconstruction and
writes the text model) and ``io/gravity_io.cc`` (per-image gravity
directions). The reference needs the whole COLMAP C++ stack for this;
here it is a plain text writer emitting the standard ``cameras.txt`` /
``images.txt`` / ``points3D.txt`` files, which round-trip through
the readers of the JAX package's ``xmtpu.pipeline.datasets`` and load in
any COLMAP tool.

The port's copy of ``xmtpu/pipeline/colmap_io.py`` (numpy; the port never
imports the JAX package, not even its numpy-only modules).
"""

from __future__ import annotations

import os

import numpy as np


def rot2quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (qw, qx, qy, qz), w >= 0 (COLMAP convention)."""
    R = np.asarray(R, dtype=np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def write_colmap_model(path: str, cameras: dict, R, t, names,
                       camera_ids=None, points=None, colors=None,
                       obs_edges=None, obs_xy=None, registered=None):
    """Write a COLMAP text model (``cameras.txt``/``images.txt``/
    ``points3D.txt``).

    Mirrors ``WriteGlomapReconstruction(..., output_format="txt")``
    (colmap_io.cc:8-63) minus color extraction: poses are cam_from_world,
    tracks with < 2 surviving observations are dropped
    (colmap_converter.cc:85), unregistered images are skipped.

    Args:
      cameras: camera_id -> :class:`xmtpu_torch.pipeline.undistort.Camera`.
      R, t: (N,3,3)/(N,3) cam_from_world poses (0-based frame order).
      names: per-frame file names; camera_ids: per-frame camera id
        (defaults to the single camera).
      points: optional (M,3); colors: optional (M,3) uint8.
      obs_edges: optional (E,2) (frame, point) observations; obs_xy: (E,2)
        pixel keypoints — fills the POINTS2D lines and track elements.
    """
    os.makedirs(path, exist_ok=True)
    R = np.asarray(R, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    N = len(R)
    if camera_ids is None:
        camera_ids = [sorted(cameras)[0]] * N
    if registered is None:
        registered = np.ones(N, dtype=bool)

    with open(os.path.join(path, "cameras.txt"), "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cid in sorted(cameras):
            cam = cameras[cid]
            params = " ".join(repr(float(p)) for p in np.asarray(cam.params))
            f.write(f"{cid} {cam.model} {cam.width} {cam.height} {params}\n")

    # group observations by frame and by point
    obs_by_frame = {}
    track_elems = {}
    point2d_index = {}
    if obs_edges is not None:
        obs_edges = np.asarray(obs_edges)
        obs_xy = np.asarray(obs_xy, dtype=np.float64)
        for k in range(len(obs_edges)):
            i, j = int(obs_edges[k, 0]), int(obs_edges[k, 1])
            if not registered[i]:
                continue
            idx = len(obs_by_frame.setdefault(i, []))
            obs_by_frame[i].append((obs_xy[k, 0], obs_xy[k, 1], j))
            track_elems.setdefault(j, []).append((i, idx))
            point2d_index[(i, j)] = idx
    kept_points = ({j for j, els in track_elems.items() if len(els) >= 2}
                   if points is not None and obs_edges is not None
                   else set(range(len(points) if points is not None else 0)))

    with open(os.path.join(path, "images.txt"), "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for i in range(N):
            if not registered[i]:
                continue
            q = rot2quat(R[i])
            vals = [q[0], q[1], q[2], q[3], t[i, 0], t[i, 1], t[i, 2]]
            f.write(f"{i + 1} " + " ".join(repr(float(v)) for v in vals)
                    + f" {camera_ids[i]} {names[i]}\n")
            pts2d = obs_by_frame.get(i, [])
            f.write(" ".join(
                f"{float(x)!r} {float(y)!r} "
                f"{j + 1 if j in kept_points else -1}"
                for x, y, j in pts2d) + "\n")

    with open(os.path.join(path, "points3D.txt"), "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        if points is not None:
            points = np.asarray(points, dtype=np.float64)
            for j in sorted(kept_points):
                c = ((128, 128, 128) if colors is None else
                     tuple(int(v) for v in np.asarray(colors)[j]))
                track = " ".join(f"{i + 1} {idx}"
                                 for i, idx in track_elems.get(j, []))
                xyz = " ".join(repr(float(v)) for v in points[j])
                f.write(f"{j + 1} {xyz} {c[0]} {c[1]} {c[2]} 0 {track}\n")


def read_gravity(gravity_path: str, names) -> dict:
    """``ReadGravity`` (gravity_io.cc:6-44): parse ``name gx gy gz`` lines,
    return {frame_index: gravity} for names present in ``names``. The
    caller aligns initial rotations with
    the JAX package's ``gravity_to_ralign`` (R_init = R_align^T,
    gravity_io.cc:37-39)."""
    name_idx = {n: i for i, n in enumerate(names)}
    out = {}
    with open(gravity_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            if parts[0] in name_idx:
                out[name_idx[parts[0]]] = np.array(
                    [float(x) for x in parts[1:4]])
    return out


def write_gravity(gravity_path: str, names, gravities) -> None:
    """``WriteGravity`` counterpart: one ``name gx gy gz`` line per image."""
    with open(gravity_path, "w") as f:
        for i, n in enumerate(names):
            g = gravities[i] if not isinstance(gravities, dict) \
                else gravities.get(i)
            if g is None:
                continue
            f.write(f"{n} " + " ".join(repr(float(v)) for v in g[:3])
                    + "\n")
