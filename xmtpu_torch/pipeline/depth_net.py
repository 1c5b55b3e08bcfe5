"""Tiny REAL monodepth network (trained weights committed in-repo).

The port's copy of ``xmtpu/pipeline/depth_net.py``.  The reference's
4_test_unidepth.py runs a learned monocular depth net (UniDepthV2 ViT-L,
4_test_unidepth.py:202-224) whose 600 MB checkpoint and package are
external; this module ships the in-repo equivalent at toy scale: a
~25k-parameter fully-convolutional CNN regressing per-pixel log-depth and
a heteroscedastic uncertainty from single grayscale views of the procedural
plane-scene family (:mod:`xmtpu_torch.pipeline.synthetic_images`).

Weights: ``xmtpu_torch/assets/tiny_monodepth.pt`` (the JAX package's
checkpoint, byte for byte).  Adapter: :class:`TinyMonoDepthModel`
implements the ``infer(rgb) -> (depth, confidence)`` interface of
:mod:`xmtpu_torch.pipeline.depth` and runs the net on ``device`` (None =
the CUDA card; raises without one unless ``"cpu"``).

The reference smooths the predicted log-depth with
``cv2.GaussianBlur(logd, (0, 0), sigma)``.  Here the same blur runs in torch
on the net's device (:func:`gaussian_blur`), by OpenCV's rules for float32
images: kernel size ``round(8 sigma + 1) | 1``, the kernel of
``getGaussianKernel``, and ``BORDER_REFLECT_101`` applied again and again
where the kernel is wider than the image.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from xmtpu_torch._device import resolve_device
from xmtpu_torch.pipeline.depth import DepthModel

WEIGHTS_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                            "assets", "tiny_monodepth.pt")


def build_net():
    """The torch module (~25k params).

    Input (B, 3, H, W): [gray/255, v/H, u/W].  Output (B, 2, H, W) after
    x4 bilinear upsampling: [log-depth, log-variance].
    """
    import torch.nn as nn

    class TinyMonoDepth(nn.Module):
        def __init__(self):
            super().__init__()
            self.body = nn.Sequential(
                nn.Conv2d(3, 16, 5, stride=2, padding=2), nn.ReLU(),
                nn.Conv2d(16, 32, 5, stride=2, padding=2), nn.ReLU(),
                nn.Conv2d(32, 32, 3, padding=2, dilation=2), nn.ReLU(),
                nn.Conv2d(32, 32, 3, padding=2, dilation=2), nn.ReLU(),
                nn.Conv2d(32, 2, 3, padding=1),
            )
            self.up = nn.Upsample(scale_factor=4, mode="bilinear",
                                  align_corners=False)

        def forward(self, x):
            return self.up(self.body(x))

    return TinyMonoDepth()


def _to_input(rgb: np.ndarray):
    """(H, W) or (H, W, 3) uint8 -> (1, 3, H, W) float32 with CoordConv
    channels."""
    img = np.asarray(rgb)
    if img.ndim == 3:
        img = img.mean(axis=-1)
    img = img.astype(np.float32) / 255.0
    H, W = img.shape
    v = np.broadcast_to(np.linspace(0, 1, H, dtype=np.float32)[:, None],
                        (H, W))
    u = np.broadcast_to(np.linspace(0, 1, W, dtype=np.float32)[None, :],
                        (H, W))
    return np.stack([img, v, u])[None]


def _reflect_101(p: np.ndarray, n: int) -> np.ndarray:
    """OpenCV's ``borderInterpolate(p, n, BORDER_REFLECT_101)``, reflected
    until the index lands inside ``[0, n)``."""
    if n == 1:
        return np.zeros_like(p)
    p = p.copy()
    out = (p < 0) | (p >= n)
    while out.any():
        p = np.where(p < 0, -p, np.where(p >= n, 2 * n - 2 - p, p))
        out = (p < 0) | (p >= n)
    return p


def blur_matrix(n: int, sigma: float) -> np.ndarray:
    """(n, n) float32 matrix of OpenCV's 1-D Gaussian pass over ``n``
    samples of a float32 image: the ``round(8 sigma + 1) | 1`` taps of
    ``getGaussianKernel`` (computed in float64, normalized, rounded to
    float32), each added onto the sample that ``BORDER_REFLECT_101`` maps
    it to."""
    k = int(round(sigma * 8 + 1)) | 1
    x = np.arange(k) - (k - 1) * 0.5
    w = np.exp(-0.5 / (sigma * sigma) * x * x)
    w = (w / w.sum()).astype(np.float32).astype(np.float64)
    r = k // 2
    src = _reflect_101(np.arange(n)[:, None] + np.arange(-r, r + 1)[None, :],
                       n)
    B = np.zeros((n, n))
    np.add.at(B, (np.repeat(np.arange(n), k), src.ravel()),
              np.tile(w, n))
    return B.astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` of an (H, W) float32 image
    on its own device: the row pass, then the column pass, each a product
    with :func:`blur_matrix`."""
    H, W = img.shape

    def mat(n):
        return torch.as_tensor(blur_matrix(n, sigma), device=img.device)

    return mat(H) @ (img @ mat(W).T)


class TinyMonoDepthModel(DepthModel):
    """Adapter running the committed tiny monodepth checkpoint on
    ``device`` (None = the CUDA card; raises without one unless ``"cpu"``).

    ``confidence = exp(-0.5 * logvar)`` scaled to max 1 — monotone in the
    net's own certainty, the same role UniDepth's confidence output plays
    in the lifting weights (4_test_unidepth.py:234-245).

    ``smooth_sigma``: gaussian smoothing of the predicted LOG-depth (px,
    :func:`gaussian_blur`).  The tiny net predicts per-pixel from a ~45 px
    receptive field; smoothing the log-depth field cuts its relative error
    ~9% -> ~5% on held-out views (the reference's measurement).  0
    disables.
    """

    def __init__(self, weights_path: str | None = None,
                 smooth_sigma: float = 50.0, device=None):
        self._device = resolve_device(device)
        self._sigma = float(smooth_sigma)
        net = build_net()
        path = weights_path or WEIGHTS_PATH
        net.load_state_dict(torch.load(path, map_location="cpu",
                                       weights_only=True))
        self._net = net.to(self._device).eval()

    def infer(self, rgb: np.ndarray):
        x = torch.from_numpy(_to_input(rgb)).to(self._device)
        with torch.no_grad():
            out = self._net(x)[0]
            logd = out[0]
            if self._sigma > 0:
                logd = gaussian_blur(logd, self._sigma)
            conf = torch.exp(-0.5 * out[1])
            conf = conf / torch.clamp_min(conf.max(), 1e-12)
            maps = torch.stack([torch.exp(logd), conf]).cpu().numpy()
        return maps[0].astype(np.float64), maps[1].astype(np.float64)
