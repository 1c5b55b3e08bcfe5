"""Synthetic SBA problem generator (pure numpy).

A copy of ``make_scene``, ``random_rotation`` and ``rotation_errors`` from
``xmtpu/pipeline/synthetic.py``, so the port never imports the JAX package.
It makes the same random draws in the same order and returns identical
arrays for the same arguments (a test checks this against the reference).

Observation model: camera i has camera-to-world rotation ``R_i``, center
``t_i`` and depth scale ``s_i``; landmark j sits at world point ``p_j``; the
depth-lifted camera-frame observation is

    x_ij = (1 / s_i) R_i^T (p_j - t_i)   (+ noise)

so the SBA residual ``w || p_j - (s_i R_i x_ij + t_i) ||^2`` vanishes at the
ground truth.  Camera 0 is the gauge anchor (t_0 = 0).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SyntheticScene(NamedTuple):
    edges: np.ndarray       # (E, 2) 1-based [frame, landmark]
    weights: np.ndarray     # (E,)
    landmarks: np.ndarray   # (E, 3) lifted observations
    rgbs: np.ndarray        # (E, 3) dummy colors
    R_gt: np.ndarray        # (N, 3, 3) camera-to-world rotations, R_0 = I
    t_gt: np.ndarray        # (N, 3) camera centers, t_0 = 0
    s_gt: np.ndarray        # (N,) positive scales, s_0 = 1
    p_gt: np.ndarray        # (M, 3) world points
    N: int
    M: int


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    A = rng.normal(size=(3, 3))
    Q, R = np.linalg.qr(A)
    Q = Q * np.sign(np.diag(R))
    if np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    return Q


def make_scene(n_cameras: int = 8, n_points: int = 60, obs_per_camera: int = 40,
               noise: float = 0.0, scale_spread: float = 0.3,
               seed: int = 0) -> SyntheticScene:
    """Generate a connected synthetic scene.

    Every point is seen by >= 2 cameras and every camera sees >= 3 points.
    The reference recounts each camera's edges by scanning the whole edge
    set inside its top-up loop (quadratic; ~90 s at n=1934); this copy keeps
    per-camera counts of the distinct edges instead, which makes the same
    draws.
    """
    rng = np.random.default_rng(seed)
    N, M = n_cameras, n_points
    obs_per_camera = min(obs_per_camera, M)

    p = rng.normal(size=(M, 3)) * 2.0
    R = np.stack([random_rotation(rng) for _ in range(N)])
    R[0] = np.eye(3)
    t = rng.normal(size=(N, 3))
    t[0] = 0.0
    s = np.exp(rng.normal(size=N) * scale_spread)
    s[0] = 1.0

    avg_obs = min(N, max(2, round(obs_per_camera * N / M)))
    edge_set = set()
    count = np.zeros(N, dtype=np.int64)   # distinct edges per camera

    def add(edge):
        if edge not in edge_set:
            edge_set.add(edge)
            count[edge[0] - 1] += 1

    for j in range(M):
        for i in rng.choice(N, size=avg_obs, replace=False):
            add((int(i) + 1, j + 1))
    for i in range(N):  # top up sparse cameras
        while count[i] < 3:
            add((i + 1, int(rng.integers(0, M)) + 1))
    edges = np.asarray(sorted(edge_set), dtype=int)

    f = edges[:, 0] - 1
    l = edges[:, 1] - 1
    x = np.einsum("nba,nb->na", R[f], p[l] - t[f]) / s[f][:, None]
    if noise > 0:
        x = x + rng.normal(size=x.shape) * noise
    w = np.ones(len(edges))
    rgbs = np.full((len(edges), 3), 128.0)
    return SyntheticScene(edges, w, x, rgbs, R, t, s, p, N, M)


def rotation_errors(R_est_blocks: np.ndarray, R_gt: np.ndarray,
                    gauge: str = "right") -> np.ndarray:
    """Angular error per camera after removing the global gauge.  Inputs
    (N, 3, 3).

    ``gauge="right"``: blocks carry a common *right* factor — compare
    ``B_i B_0^T`` against ``G_i G_0^T``.  ``gauge="left"``: common left factor
    — compare ``B_0^T B_i``.
    """
    if gauge == "right":
        rel_est = np.einsum("nab,cb->nac", R_est_blocks, R_est_blocks[0])
        rel_gt = np.einsum("nab,cb->nac", R_gt, R_gt[0])
    else:
        rel_est = np.einsum("ba,nbc->nac", R_est_blocks[0], R_est_blocks)
        rel_gt = np.einsum("ba,nbc->nac", R_gt[0], R_gt)
    prod = np.einsum("nab,ncb->nac", rel_est, rel_gt)
    cos = np.clip((np.trace(prod, axis1=1, axis2=2) - 1) / 2, -1, 1)
    return np.arccos(cos)
