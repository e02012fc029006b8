"""Eval preprocessing of uint8 clips: Resize((res, res)) bilinear without
antialiasing (torchvision's resize of video tensors), then Normalize with
LaViLa's mean and std (in 0..255 units)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

MEAN = torch.tensor([108.3272985, 116.7460125, 104.09373615]) / 255
STD = torch.tensor([68.5005327, 66.6321579, 70.32316305]) / 255


def resize_normalize(video_u8: torch.Tensor, res: int) -> torch.Tensor:
    """(B, T, H, W, C) uint8 -> (B, T, res, res, C) float32."""
    b, t, h, w, c = video_u8.shape
    x = video_u8.float() / 255.0
    if (h, w) != (res, res):
        x = x.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
        x = F.interpolate(x, size=(res, res), mode="bilinear", align_corners=False, antialias=False)
        x = x.permute(0, 2, 3, 1).reshape(b, t, res, res, c)
    return (x - MEAN.to(x.device)) / STD.to(x.device)
