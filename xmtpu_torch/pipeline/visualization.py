"""Visualization: camera frusta + point clouds, exported to PLY.

The headless part of ``xmtpu/pipeline/visualization.py`` (a re-design of
the reference's utils/visualization.py:4-65): the frusta as line sets and
the landmarks as colored points, viewable in any mesh tool.  ``recover
--ply`` of the command line writes them.  The open3d viewers come with the
rest of the pipeline.
"""

from __future__ import annotations

import numpy as np


def camera_frustum_lines(extrinsic: np.ndarray, scale: float = 0.1):
    """Frustum corner points + line index pairs for one 4x4 w2c extrinsic
    (visualization.py:4-27)."""
    points = np.array([
        [0, 0, 0],
        [-0.5, -0.5, 1], [0.5, -0.5, 1], [0.5, 0.5, 1], [-0.5, 0.5, 1],
    ]) * scale
    lines = np.array([[0, 1], [0, 2], [0, 3], [0, 4],
                      [1, 2], [2, 3], [3, 4], [4, 1]])
    R = extrinsic[:3, :3]
    t = extrinsic[:3, 3]
    # camera-frame corners -> world: x_w = R^T (x_c - t)
    world = (R.T @ (points.T - t[:, None])).T
    return world, lines


def _gather_geometry(extrinsics, points=None, colors=None, scale=0.1):
    all_pts, all_lines = [], []
    offset = 0
    for ext in extrinsics:
        w, l = camera_frustum_lines(np.asarray(ext), scale)
        all_pts.append(w)
        all_lines.append(l + offset)
        offset += len(w)
    frustum_pts = np.concatenate(all_pts, axis=0)
    frustum_lines = np.concatenate(all_lines, axis=0)
    cloud = None if points is None else np.asarray(points)
    return frustum_pts, frustum_lines, cloud, colors


def export_ply(path_prefix: str, extrinsics, points=None, colors=None,
               scale: float = 0.1):
    """Headless export: ``<prefix>_cameras.ply`` (line set) and
    ``<prefix>_points.ply`` (point cloud)."""
    fp, fl, cloud, colors = _gather_geometry(extrinsics, points, colors, scale)
    with open(path_prefix + "_cameras.ply", "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(fp)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                f"element edge {len(fl)}\n"
                "property int vertex1\nproperty int vertex2\nend_header\n")
        for p in fp:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
        for a, b in fl:
            f.write(f"{a} {b}\n")
    if cloud is not None:
        cols = (np.asarray(colors) * 255).astype(int) if colors is not None \
            else np.full((len(cloud), 3), 200, dtype=int)
        with open(path_prefix + "_points.ply", "w") as f:
            f.write("ply\nformat ascii 1.0\n"
                    f"element vertex {len(cloud)}\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                    "end_header\n")
            for p, c in zip(cloud, cols):
                f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
