"""Device resolution shared by every entry point of the port.

The port runs on a CUDA card unless the caller asks for the host: an entry
point given ``device=None`` means ``"cuda"`` and raises when no card is
present — it never falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; ``"cpu"`` only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "xmtpu_torch: no CUDA device is available; pass device='cpu' to "
            "run on the host")
    return dev
