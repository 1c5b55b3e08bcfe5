"""The benchmark's problem generators: frozen numpy copies.

``make_scene`` and ``make_scene_window`` are copies of the port's
``xmtpu_torch/pipeline/synthetic.py`` generators, kept here so that what
the benchmark solves cannot change when the program does.  They make the
same draws in the same order, and ``tests/test_pb_scenes.py`` holds them to
the port's bits at small sizes.  ``seed`` is anything
``numpy.random.default_rng`` takes: the configurations list theirs.

Observation model: camera i has camera-to-world rotation ``R_i``, center
``t_i`` and depth scale ``s_i``; landmark j sits at ``p_j``; the lifted
camera-frame observation is ``x_ij = (1 / s_i) R_i^T (p_j - t_i)`` plus
Gaussian noise.  Camera 0 is the gauge anchor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Scene(NamedTuple):
    edges: np.ndarray       # (E, 2) 1-based [frame, landmark]
    weights: np.ndarray     # (E,)
    landmarks: np.ndarray   # (E, 3) lifted observations
    rgbs: np.ndarray        # (E, 3)
    R_gt: np.ndarray        # (N, 3, 3)
    t_gt: np.ndarray        # (N, 3)
    s_gt: np.ndarray        # (N,)
    p_gt: np.ndarray        # (M, 3)
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
               seed=0) -> Scene:
    """A connected scene: every point seen by >= 2 cameras, every camera
    seeing >= 3 points."""
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
    count = np.zeros(N, dtype=np.int64)

    def add(edge):
        if edge not in edge_set:
            edge_set.add(edge)
            count[edge[0] - 1] += 1

    for j in range(M):
        for i in rng.choice(N, size=avg_obs, replace=False):
            add((int(i) + 1, j + 1))
    for i in range(N):
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
    return Scene(edges, w, x, rgbs, R, t, s, p, N, M)


def make_scene_window(n_cameras: int, n_points: int, obs_per_camera: int = 20,
                      noise: float = 0.0, scale_spread: float = 0.3,
                      seed=0, long_range: int = 0) -> Scene:
    """Camera i sees a wrap-around window of ``obs_per_camera`` landmarks
    from ``floor(i M / N)``, plus ``long_range`` random landmarks."""
    rng = np.random.default_rng(seed)
    N, M, k = n_cameras, n_points, obs_per_camera
    if N * k < 2 * M:
        raise ValueError("need >= 2 observations per landmark on average")

    p = rng.normal(size=(M, 3)) * 2.0
    A = rng.normal(size=(N, 3, 3))
    Q, R = np.linalg.qr(A)
    Q = Q * np.sign(np.einsum("nii->ni", R))[:, None, :]
    det = np.linalg.det(Q)
    Q[det < 0, :, 0] *= -1.0
    Rot = Q
    Rot[0] = np.eye(3)
    t = rng.normal(size=(N, 3))
    t[0] = 0.0
    s = np.exp(rng.normal(size=N) * scale_spread)
    s[0] = 1.0

    start = (np.arange(N, dtype=np.int64) * M) // N
    f = np.repeat(np.arange(N, dtype=np.int64), k)
    l = (start[:, None] + np.arange(k, dtype=np.int64)[None, :]) % M
    l = l.ravel()
    if long_range:
        f = np.concatenate([f, np.repeat(np.arange(N, dtype=np.int64),
                                         long_range)])
        l = np.concatenate([l, rng.integers(0, M, size=N * long_range)])

    x = np.einsum("eba,eb->ea", Rot[f], p[l] - t[f]) / s[f][:, None]
    if noise > 0:
        x = x + rng.normal(size=x.shape) * noise
    edges = np.stack([f + 1, l + 1], axis=1)
    w = np.ones(len(edges))
    rgbs = np.full((len(edges), 3), 128.0)
    return Scene(edges, w, x, rgbs, Rot, t, s, p, N, M)


GENERATORS = {"make_scene": make_scene, "make_scene_window": make_scene_window}
