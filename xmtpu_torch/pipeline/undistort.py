"""Camera models and feature undistortion (COLMAP model family).

The reference's GLOMAP fork undistorts every feature into a unit bearing
before any geometry runs (UndistortImages,
deps/glomap/glomap/processors/image_undistorter.cc:7-43,
calling colmap ``Camera::CamFromImg(...).homogeneous().normalized()`` per
point with a host thread pool). xmtpu implements the COLMAP camera-model
family natively and vectorized: one numpy pass per image instead of a
thread pool over scalar loops.

Supported models (COLMAP parameter order):

================  ==========================================
SIMPLE_PINHOLE    f, cx, cy
PINHOLE           fx, fy, cx, cy
SIMPLE_RADIAL     f, cx, cy, k1
RADIAL            f, cx, cy, k1, k2
OPENCV            fx, fy, cx, cy, k1, k2, p1, p2
FULL_OPENCV       fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, k5, k6
OPENCV_FISHEYE    fx, fy, cx, cy, k1, k2, k3, k4
================  ==========================================

Undistortion inverts the distortion by damped fixed-point/Newton iteration,
matching colmap's ``IterativeUndistortion`` semantics (convergence to
sub-1e-10 normalized-coordinate accuracy in a handful of iterations for
realistic distortion magnitudes).

The port's copy of ``xmtpu/pipeline/undistort.py`` (numpy; the port never
imports the JAX package, not even its numpy-only modules).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

_FOCAL_LAYOUT = {
    # model: (fx_idx, fy_idx, cx_idx, cy_idx, first_dist_idx)
    "SIMPLE_PINHOLE": (0, 0, 1, 2, 3),
    "PINHOLE": (0, 1, 2, 3, 4),
    "SIMPLE_RADIAL": (0, 0, 1, 2, 3),
    "RADIAL": (0, 0, 1, 2, 3),
    "OPENCV": (0, 1, 2, 3, 4),
    "FULL_OPENCV": (0, 1, 2, 3, 4),
    "OPENCV_FISHEYE": (0, 1, 2, 3, 4),
}


@dataclass
class Camera:
    """A COLMAP-style camera: model name + flat parameter vector."""

    model: str
    params: np.ndarray
    width: int = 0
    height: int = 0
    has_prior_focal_length: bool = False

    def __post_init__(self):
        if self.model not in _FOCAL_LAYOUT:
            raise ValueError(f"Unsupported camera model: {self.model}")
        self.params = np.asarray(self.params, dtype=np.float64)

    @property
    def K(self) -> np.ndarray:
        fx, fy, cx, cy, _ = _FOCAL_LAYOUT[self.model]
        K = np.eye(3)
        K[0, 0] = self.params[fx]
        K[1, 1] = self.params[fy]
        K[0, 2] = self.params[cx]
        K[1, 2] = self.params[cy]
        return K

    @property
    def dist(self) -> np.ndarray:
        return self.params[_FOCAL_LAYOUT[self.model][4]:]

    @property
    def focal(self) -> float:
        fx, fy, _, _, _ = _FOCAL_LAYOUT[self.model]
        return 0.5 * (self.params[fx] + self.params[fy])


def distort(camera: Camera, xy: np.ndarray) -> np.ndarray:
    """Apply the model's distortion to normalized camera coords (N, 2)."""
    xy = np.asarray(xy, dtype=np.float64).reshape(-1, 2)
    d = camera.dist
    x, y = xy[:, 0], xy[:, 1]
    m = camera.model
    if m in ("SIMPLE_PINHOLE", "PINHOLE") or d.size == 0:
        return xy.copy()
    r2 = x * x + y * y
    if m == "SIMPLE_RADIAL":
        f = 1.0 + d[0] * r2
        return np.stack([x * f, y * f], axis=1)
    if m == "RADIAL":
        f = 1.0 + r2 * (d[0] + d[1] * r2)
        return np.stack([x * f, y * f], axis=1)
    if m in ("OPENCV", "FULL_OPENCV"):
        k1, k2, p1, p2 = d[0], d[1], d[2], d[3]
        if m == "FULL_OPENCV":
            k3, k4, k5, k6 = d[4], d[5], d[6], d[7]
            radial = ((1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))) /
                      (1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))))
        else:
            radial = 1.0 + r2 * (k1 + r2 * k2)
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return np.stack([xd, yd], axis=1)
    if m == "OPENCV_FISHEYE":
        k1, k2, k3, k4 = d[0], d[1], d[2], d[3]
        r = np.sqrt(np.maximum(r2, 1e-300))
        theta = np.arctan(r)
        t2 = theta * theta
        theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        scale = np.where(r > 1e-12, theta_d / r, 1.0)
        return np.stack([x * scale, y * scale], axis=1)
    raise ValueError(f"Unsupported camera model: {m}")


def undistort(camera: Camera, xy_dist: np.ndarray, max_iters: int = 100,
              tol: float = 1e-12) -> np.ndarray:
    """Invert :func:`distort` on normalized coords by damped Newton iteration
    with numeric Jacobians (colmap IterativeUndistortion semantics)."""
    xy_dist = np.asarray(xy_dist, dtype=np.float64).reshape(-1, 2)
    if camera.model in ("SIMPLE_PINHOLE", "PINHOLE") or camera.dist.size == 0:
        return xy_dist.copy()
    xy = xy_dist.copy()
    eps = 1e-8
    for _ in range(max_iters):
        f0 = distort(camera, xy)
        err = f0 - xy_dist
        if np.max(np.abs(err)) < tol:
            break
        # numeric 2x2 Jacobian per point
        fx = distort(camera, xy + np.array([eps, 0.0])) - f0
        fy = distort(camera, xy + np.array([0.0, eps])) - f0
        J = np.stack([fx, fy], axis=2) / eps          # (N, 2, 2)
        det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        det = np.where(np.abs(det) < 1e-30, 1e-30, det)
        dx = (J[:, 1, 1] * err[:, 0] - J[:, 1, 0] * err[:, 1]) / det
        dy = (-J[:, 0, 1] * err[:, 0] + J[:, 0, 0] * err[:, 1]) / det
        xy = xy - np.stack([dx, dy], axis=1)
    return xy


def cam_from_img(camera: Camera, uv: np.ndarray) -> np.ndarray:
    """Pixels (N, 2) -> undistorted normalized camera coords (N, 2)
    (colmap Camera::CamFromImg)."""
    uv = np.asarray(uv, dtype=np.float64).reshape(-1, 2)
    K = camera.K
    xy = (uv - K[:2, 2]) / np.array([K[0, 0], K[1, 1]])
    return undistort(camera, xy)


def undistorted_bearings(camera: Camera, uv: np.ndarray) -> np.ndarray:
    """Pixels (N, 2) -> unit bearing vectors (N, 3) — the reference's
    ``features_undist`` (image_undistorter.cc:34-35:
    CamFromImg(...).homogeneous().normalized())."""
    xy = cam_from_img(camera, uv)
    h = np.concatenate([xy, np.ones((len(xy), 1))], axis=1)
    return h / np.linalg.norm(h, axis=1, keepdims=True)


def undistort_images(cameras: dict, keypoints: dict) -> dict:
    """Batch API over the scene: {image_id: (N,2) pixels} ->
    {image_id: (N,3) unit bearings} given {image_id: Camera} (the
    UndistortImages pass, vectorized per image instead of thread-pooled
    per point)."""
    return {img_id: undistorted_bearings(cameras[img_id], uv)
            for img_id, uv in keypoints.items()}
