"""Monocular depth-model adapters for the learned-depth pipeline.

The port's copy of ``xmtpu/pipeline/depth.py``; :class:`UniDepthModel`
runs on ``device`` (None = the CUDA card; raises without one unless
``"cpu"``), never falling back to the host on its own.

The reference's 4_test_unidepth.py runs UniDepthV2 inference inline
(4_test_unidepth.py:202-224): ``model.infer(rgb)`` returning
a depth map and a per-pixel confidence, lifted with border-margin and
95th-percentile clipping (:234-245) into the solver's observations.  The
model itself is an external PyTorch package (cloned into deps/ at install
time, README.md:87-99) — external even in the reference.

xmtpu formalizes the boundary as a one-method adapter:

    infer(rgb: (H, W, 3) uint8) -> (depth (H, W) float, confidence (H, W))

Anything implementing it plugs into :func:`depth_for_frames` /
``run_frontend(depth_model=...)`` — the real UniDepth wrapper
(:class:`UniDepthModel`, lazy unidepth import), a plain callable
(:class:`CallableDepthModel`), or ground-truth depth with a synthetic error
model (:class:`NoisyDepthModel`, the test/CI stand-in).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from xmtpu_torch._device import resolve_device


class DepthModel:
    """Adapter interface: ``infer(rgb) -> (depth, confidence)``."""

    def infer(self, rgb: np.ndarray):
        raise NotImplementedError


class CallableDepthModel(DepthModel):
    """Wrap any ``fn(rgb) -> (depth, confidence)`` callable."""

    def __init__(self, fn: Callable[[np.ndarray], tuple]):
        self._fn = fn

    def infer(self, rgb: np.ndarray):
        depth, conf = self._fn(rgb)
        return np.asarray(depth, np.float64), np.asarray(conf, np.float64)


class NoisyDepthModel(DepthModel):
    """Ground-truth depth + a monocular-net error model: relative
    (depth-proportional) gaussian noise and confidence anti-correlated with
    depth — the solver-side statistics of 4_test_unidepth.py without the 600 MB
    checkpoint.  ``gt_for_rgb`` maps the rgb array (by id) to its GT depth.
    """

    def __init__(self, images: Sequence[np.ndarray],
                 gt_depths: Sequence[np.ndarray],
                 rel_sigma: float = 0.02, seed: int = 0):
        self._by_id = {id(im): np.asarray(d, np.float64)
                       for im, d in zip(images, gt_depths)}
        self._rel_sigma = rel_sigma
        self._rng = np.random.default_rng(seed)

    def infer(self, rgb: np.ndarray):
        gt = self._by_id[id(rgb)]
        depth = gt + self._rng.normal(size=gt.shape) * self._rel_sigma * gt
        conf = 1.0 / (1.0 + self._rel_sigma * np.abs(gt))
        conf[gt <= 0] = 0.0
        return depth, conf


class UniDepthModel(DepthModel):
    """UniDepthV2 adapter (4_test_unidepth.py:202-224 semantics).

    Lazy-imports the external ``unidepth`` package at construction and
    raises a helpful ImportError without it (the adapter is the wiring, the
    checkpoint is deployment-side, exactly as in the reference).  The model
    is moved to ``device`` (None = the CUDA card; raises without one unless
    ``"cpu"``); nothing is fetched here beyond ``from_pretrained``.
    """

    def __init__(self, model=None, name: str = "unidepth-v2-vitl14",
                 device=None):
        dev = resolve_device(device)
        if model is None:
            try:
                from unidepth.models import UniDepthV2
            except ImportError as e:
                raise ImportError(
                    "UniDepthModel needs the external 'unidepth' package "
                    "(github.com/lpiccinelli-eth/UniDepth); pass any "
                    "DepthModel/callable instead") from e
            model = UniDepthV2.from_pretrained(f"lpiccinelli/{name}")
            model = model.to(dev).eval()
        self._model = model

    def infer(self, rgb: np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(rgb)).permute(2, 0, 1)
        with torch.no_grad():
            pred = self._model.infer(t)
        depth = pred["depth"].squeeze().cpu().numpy().astype(np.float64)
        conf = pred.get("confidence")
        if conf is None:
            conf = np.ones_like(depth)
        else:
            conf = conf.squeeze().cpu().numpy().astype(np.float64)
        return depth, conf


def as_depth_model(model) -> DepthModel:
    if isinstance(model, DepthModel):
        return model
    if callable(model):
        return CallableDepthModel(model)
    raise TypeError(f"not a depth model: {type(model)}")


def depth_for_frames(model, images: Sequence[np.ndarray]):
    """Bind a depth model to a frame list: returns the
    ``depth_for_frame(i) -> (depth, conf)`` callable the front end consumes,
    with per-frame memoization (inference is the expensive part)."""
    model = as_depth_model(model)
    cache: dict = {}

    def depth_for_frame(i: int):
        if i not in cache:
            cache[i] = model.infer(images[i])
        return cache[i]

    return depth_for_frame
