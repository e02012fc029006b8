"""Device-side eval preprocessing of uint8 clips.

Counterpart of the eval transforms in
``helping_hand_for_egocentric_videos_tpu/ops/preprocess.py``:

- ``resize_normalize``: Resize((res, res)) + Normalize.
- ``shortside_centercrop_normalize``: Resize(short side) -> CenterCrop ->
  Resize(res) -> Normalize.

Clips stay channel-last, (..., H, W, C). Resizes are bilinear with
``align_corners=False`` and no antialiasing: the reference resizes video
tensors, where torch interpolates without antialiasing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "LAVILA_MEAN",
    "LAVILA_STD",
    "resize_normalize",
    "shortside_centercrop_normalize",
    "shortside_dims",
]

LAVILA_MEAN = (108.3272985 / 255, 116.7460125 / 255, 104.09373615 / 255)
LAVILA_STD = (68.5005327 / 255, 66.6321579 / 255, 70.32316305 / 255)


def shortside_dims(h: int, w: int, short: int) -> tuple[int, int]:
    """Target (nh, nw) for a shorter-side resize to ``short``. The long
    side truncates (torchvision Resize(int) geometry), so a fractional
    part >= 0.5 must not round up."""
    if h <= w:
        return short, max(int(w * short / h), short)
    return max(int(h * short / w), short), short


def _resize(x, size: tuple[int, int]):
    """(..., H, W, C) float -> (..., h, w, C), bilinear, no antialias."""
    *lead, h, w, c = x.shape
    y = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=size, mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, *size, c)


def _channels(values, like):
    """A (C,) tensor of ``values`` made on ``like``'s device by fills, not
    by a copy from the host (which would wait for the device)."""
    return torch.stack([torch.full((), v, dtype=like.dtype, device=like.device) for v in values])


def _norm(x, mean, std):
    return (x - _channels(mean, x)) / _channels(std, x)


def resize_normalize(video_u8, res: int = 224, mean=LAVILA_MEAN, std=LAVILA_STD, dtype=torch.float32):
    """(..., H, W, C) uint8 -> (..., res, res, C) normalised float."""
    x = video_u8.to(dtype) / 255.0
    if tuple(video_u8.shape[-3:-1]) != (res, res):
        x = _resize(x, (res, res))
    return _norm(x, mean, std)


def shortside_centercrop_normalize(
    video_u8, short: int = 256, res: int = 224, mean=LAVILA_MEAN, std=LAVILA_STD, dtype=torch.float32
):
    """Resize(shorter side=short) -> CenterCrop(short) -> Resize(res) ->
    Normalize."""
    h, w = video_u8.shape[-3:-1]
    x = video_u8.to(dtype) / 255.0
    nh, nw = shortside_dims(h, w, short)
    x = _resize(x, (nh, nw))
    top, left = (nh - short) // 2, (nw - short) // 2
    x = x[..., top : top + short, left : left + short, :]
    if short != res:
        x = _resize(x, (res, res))
    return _norm(x, mean, std)
