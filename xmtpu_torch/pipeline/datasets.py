"""Dataset ground-truth loaders: BAL, Replica, TUM, COLMAP text models.

Re-designs of utils/readgt_{BAL,replica,TUM,colmap}.py without
the pandas dependency; the port's copy of ``xmtpu/pipeline/datasets.py``
(numpy).  Every loader returns the reference's dict convention:
``{key: {"id", "K", "R", "t", "camera_id"}}`` with (R, t) the world-to-camera
projection, plus a ``load_*_camera`` companion returning COLMAP-style camera
dicts ``{camera_id: {"model", "width", "height", "params"}}``.
"""

from __future__ import annotations

import os

import numpy as np

from xmtpu_torch.io.bin_format import load_matrix_from_bin
from xmtpu_torch.pipeline.frontend import quat2rot


# ---------------------------------------------------------------- BAL

def load_BAL_gt(dataset_path: str) -> dict:
    """BAL fixtures ship ``gtR.bin`` (3, 3N) and ``gtt.bin`` (3, N)
    (readgt_BAL.py:10-28)."""
    gtR, _ = load_matrix_from_bin(os.path.join(dataset_path, "gtR.bin"))
    gtT, _ = load_matrix_from_bin(os.path.join(dataset_path, "gtt.bin"))
    N = gtT.shape[1]
    return {
        i: {"R": gtR[:, 3 * i:3 * (i + 1)], "t": gtT[:, i], "camera_id": 1}
        for i in range(N)
    }


def load_BAL_camera(dataset_path: str) -> dict:
    return {1: {"model": "PINHOLE", "width": 2, "height": 2,
                "params": [1, 1, 1, 1]}}


# ---------------------------------------------------------------- Replica

_REPLICA_K = np.array([[600.0, 0, 599.5], [0, 600.0, 339.5], [0, 0, 1]])


def load_replica_gt(dataset_path: str) -> dict:
    """``traj.txt`` rows are flattened 4x4 camera-to-world poses; convert to
    world-to-camera (readgt_replica.py:9-32)."""
    data = np.atleast_2d(np.loadtxt(os.path.join(dataset_path, "traj.txt")))
    results = {}
    for i in range(data.shape[0]):
        pose = data[i].reshape(4, 4)
        R = pose[:3, :3].T
        t = -pose[:3, :3].T @ pose[:3, 3]
        results[f"frame{i:06d}.jpg"] = {
            "id": i, "K": _REPLICA_K, "R": R, "t": t, "camera_id": 1}
    return results


def load_replica_camera(dataset_path: str) -> dict:
    return {1: {"model": "PINHOLE", "width": 1200, "height": 680,
                "params": [600, 600, 599.5, 339.5]}}


# ---------------------------------------------------------------- TUM

_TUM_PARAMS = [517.3, 516.5, 318.6, 255.3]


def load_tum_gt(dataset_path: str) -> dict:
    """TUM RGB-D: timestamped images matched to ``groundtruth.txt`` poses by
    linear interpolation of (t, q) (readgt_TUM.py:16-59)."""
    image_dir = os.path.join(dataset_path, "images")
    all_files = sorted(f for f in os.listdir(image_dir)
                       if os.path.isfile(os.path.join(image_dir, f)))
    fx, fy, cx, cy = _TUM_PARAMS
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    data = np.loadtxt(os.path.join(dataset_path, "groundtruth.txt"),
                      comments="#")
    timestamps = data[:, 0]
    txyz = data[:, 1:4]
    # groundtruth.txt order is tx ty tz qx qy qz qw; loader uses (qw,qx,qy,qz)
    q = data[:, (7, 4, 5, 6)]

    results = {}
    for i, fname in enumerate(all_files):
        timestamp = float(fname.replace(".png", ""))
        pos = int(np.searchsorted(timestamps, timestamp))
        if pos == 0:
            qi, ti = q[0], txyz[0]
        elif pos == len(timestamps):
            qi, ti = q[-1], txyz[-1]
        else:
            f = (timestamp - timestamps[pos - 1]) / (timestamps[pos] - timestamps[pos - 1])
            qi = (1 - f) * q[pos - 1] + f * q[pos]
            ti = (1 - f) * txyz[pos - 1] + f * txyz[pos]
        qi = qi / np.linalg.norm(qi)
        R = quat2rot(*qi).T
        t = -R @ ti
        results[fname] = {"id": i, "K": K, "R": R, "t": t, "camera_id": 1}
    return results


def load_tum_camera(dataset_path: str) -> dict:
    return {1: {"model": "PINHOLE", "width": 640, "height": 480,
                "params": _TUM_PARAMS}}


# ---------------------------------------------------------------- COLMAP text

def _parse_camera_K(model: str, params: list[float]) -> np.ndarray:
    """Intrinsics matrix for any COLMAP camera model (distortion handled by
    xmtpu_torch.pipeline.undistort for the non-pinhole members of the family)."""
    from xmtpu_torch.pipeline.undistort import Camera
    return Camera(model, np.asarray(params)).K


def load_camera_models(file_path: str) -> dict:
    """Parse a COLMAP ``cameras.txt`` into full camera models (with
    distortion parameters), {camera_id: undistort.Camera}. Companion of
    :func:`load_camera_data` for non-pinhole captures."""
    from xmtpu_torch.pipeline.undistort import Camera
    cams = {}
    with open(file_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cams[int(parts[0])] = Camera(
                parts[1], np.array(list(map(float, parts[4:]))),
                width=int(parts[2]), height=int(parts[3]))
    return cams


def load_camera_data(file_path: str) -> dict:
    """Parse a COLMAP ``cameras.txt``; returns {camera_id: (K, width, height)}
    (readgt_colmap.py:15-50)."""
    cams = {}
    with open(file_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            model = parts[1]
            width, height = int(parts[2]), int(parts[3])
            K = _parse_camera_K(model, list(map(float, parts[4:])))
            cams[cam_id] = (K, width, height)
    return cams


def load_image_data(file_path: str) -> dict:
    """Parse a COLMAP ``images.txt`` (pose lines only, every other line);
    returns {name: (image_id, camera_id, qw,qx,qy,qz, t)}
    (readgt_colmap.py:66-91)."""
    images = {}
    expecting_points = False
    with open(file_path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("#"):
                continue
            if expecting_points:
                # POINTS2D line — may be empty for images without points
                expecting_points = False
                continue
            if not line:
                continue
            expecting_points = True
            parts = line.split()
            image_id = int(parts[0])
            qw, qx, qy, qz = map(float, parts[1:5])
            t = np.array(list(map(float, parts[5:8])))
            camera_id = int(parts[8])
            name = parts[9]
            images[name] = (image_id, camera_id, (qw, qx, qy, qz), t)
    return images


def load_colmap_camera(gt_path: str) -> dict:
    cams = load_camera_data(os.path.join(gt_path, "sparse", "cameras.txt"))
    return {cid: {"model": "PINHOLE", "width": w, "height": h,
                  "params": [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]}
            for cid, (K, w, h) in cams.items()}


def load_colmap_gt(gt_path: str) -> dict:
    cams = load_camera_data(os.path.join(gt_path, "sparse", "cameras.txt"))
    images = load_image_data(os.path.join(gt_path, "sparse", "images.txt"))
    results = {}
    for name, (image_id, camera_id, quat, t) in images.items():
        K = cams[camera_id][0] if camera_id in cams else None
        results[name] = {"id": camera_id, "K": K, "R": quat2rot(*quat),
                         "t": t, "camera_id": camera_id}
    return results


def load_gt_depth(gt_path: str) -> dict:
    """Sparse GT depth per image: ``depth_gt.bin`` rows are
    (image_id, u, v, _, depth); grouped by image name
    (readgt_colmap.py:93-112)."""
    images = load_image_data(os.path.join(gt_path, "images.txt"))
    id_to_name = {iid: name for name, (iid, *_rest) in images.items()}
    depth, _ = load_matrix_from_bin(os.path.join(gt_path, "depth_gt.bin"))
    depth = depth[:, (0, 1, 2, 4)]
    grouped = {}
    for iid in np.unique(depth[:, 0]):
        name = id_to_name.get(int(iid))
        if name is None:
            continue
        rows = depth[depth[:, 0] == iid]
        grouped[name] = {"COORD1": rows[:, 1], "COORD2": rows[:, 2],
                         "DEPTH": rows[:, 3]}
    return grouped
