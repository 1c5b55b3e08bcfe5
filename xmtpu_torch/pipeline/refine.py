"""SO(3) exponential map of the pose refinement (``xmtpu/pipeline/refine.py``).

Only ``_expm_so3`` (and its ``_hat``) is ported so far: rotation averaging
and bundle adjustment update their rotations with it.  The Gauss--Newton
refinement itself (``refine_bundle``) is not ported yet.
"""

from __future__ import annotations

import torch


def _hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
    ], dim=-2)


def _expm_so3(w):
    """Rodrigues: (..., 3) rotation vector -> (..., 3, 3).

    Written as ``I + A hat(w) + B hat(w)^2`` with A = sin(t)/t and
    B = (1-cos(t))/t^2, the small-angle series taken below t^2 = 1e-12 (the
    reference's branches, selected with ``torch.where`` on a safe argument
    so that the untaken branch never divides by zero).
    """
    t2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = t2 < 1e-12
    t2s = torch.where(small, 1.0, t2)
    theta = torch.sqrt(t2s)
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
    K = _hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + A * K + B * (K @ K)
