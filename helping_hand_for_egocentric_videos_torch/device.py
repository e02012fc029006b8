"""Device resolution: entry points run on the CUDA device by default."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises when a CUDA device is asked for and
    none is present: running on the CPU must be asked for explicitly
    (``device="cpu"``), never taken silently."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device
