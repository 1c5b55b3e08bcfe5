"""Procedural image rendering with analytic depth ground truth.

Renders views of a textured 3-D plane by homography warp — the same
construction as the pixels-to-poses integration test
(tests/test_images_end_to_end.py), factored here so the tiny monodepth
trainer and the tests draw from one scene family.  The texture is unit-variance gaussian-blurred noise with a FIXED
spatial scale in WORLD units: under perspective its image-space frequency
is proportional to 1/Z, which is exactly the monocular cue the depth net
learns (4_test_unidepth.py runs a monocular net over real images; this is
the self-contained analog with exact analytic depth labels).

Requires cv2 (import-guarded; callers skip when absent).  The port's copy
of ``xmtpu/pipeline/synthetic_images.py``: the view rotations come from the
port's ``_expm_so3`` on a host float64 tensor (this is data generation on
the host).
"""

from __future__ import annotations

import numpy as np


def make_texture(size: int = 400, seed: int = 0, sigma: float = 1.5):
    import cv2

    rng = np.random.default_rng(seed)
    img = (rng.random((size, size)) * 255).astype(np.uint8)
    img = cv2.GaussianBlur(img, (0, 0), sigma)
    return cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX)


def render_plane_views(n_views: int = 5, seed: int = 1, size: int = 400,
                       focal: float = 300.0, z0: float = 4.0,
                       half: float = 1.5, rot_sigma: float = 0.03,
                       trans_sigma=(0.3, 0.3, 0.1), tex_seed: int = 0):
    """Views of the plane ``z = z0`` textured by :func:`make_texture`
    (world X,Y in [-half, half]^2 maps linearly to texture pixels).

    Returns ``(images, depths, R_gt (n,3,3) c2w, t_gt (n,3) centers, K)``.
    View 0 is the identity pose; depth maps are analytic ray-plane
    intersections with warp-border pixels zeroed (invalid).
    """
    import cv2

    import torch

    from xmtpu_torch.pipeline.refine import _expm_so3

    rng = np.random.default_rng(seed)
    tex = make_texture(size, tex_seed)
    K = np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1.0]])

    def tex_to_world(u, v):
        X = (u / (size - 1) * 2 - 1) * half
        Y = (v / (size - 1) * 2 - 1) * half
        return np.stack([X, Y, np.full_like(X, z0, dtype=float)], axis=-1)

    images, depths, R_gt, t_gt = [], [], [], []
    for i in range(n_views):
        if i == 0:
            R = np.eye(3)
            c = np.zeros(3)
        else:
            w = rng.normal(size=3) * rot_sigma
            R = _expm_so3(torch.as_tensor(w)).numpy()  # c2w
            c = rng.normal(size=3) * np.asarray(trans_sigma)
        Rw2c = R.T
        tw2c = -Rw2c @ c

        corners_t = np.array([[0, 0], [size - 1, 0], [size - 1, size - 1],
                              [0, size - 1]], float)
        Pw = tex_to_world(corners_t[:, 0], corners_t[:, 1])
        Pc = (Rw2c @ Pw.T).T + tw2c
        proj = (K @ Pc.T).T
        proj = proj[:, :2] / proj[:, 2:3]
        H = cv2.getPerspectiveTransform(corners_t.astype(np.float32),
                                        proj.astype(np.float32))
        img = cv2.warpPerspective(tex, H, (size, size))

        n_w = np.array([0.0, 0, 1])
        n_c = Rw2c @ n_w
        d0 = n_w @ (np.array([0, 0, z0]) - c)
        uu, vv = np.meshgrid(np.arange(size), np.arange(size))
        rays = np.linalg.inv(K) @ np.stack(
            [uu.ravel(), vv.ravel(), np.ones(size * size)])
        z = d0 / (n_c @ rays)
        depth = z.reshape(size, size)
        depth[img == 0] = 0.0

        images.append(img)
        depths.append(depth)
        R_gt.append(R)
        t_gt.append(c)
    return images, depths, np.stack(R_gt), np.stack(t_gt), K
