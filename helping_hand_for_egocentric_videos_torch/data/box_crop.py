"""Box-aware clip cropping (the reference's ``custom_img_crop``).

Host-side numpy equivalent of data_loader/transforms.py:78-151 — crop a
clip to (an expanded window around) the union of its hand/object boxes.
Off by default in the reference (``crop_w_boxes=False``) and unused by
the released models; provided for capability parity. The companion
``crop_boxes`` (utils/box_ops.py:107-135) shifts/clips/rescales the boxes
into the crop.

A copy of ``helping_hand_for_egocentric_videos_tpu/data/box_crop.py`` (the port imports
nothing of the JAX package); it runs on the host without JAX, so the same inputs and seed give
the same result in both packages.
"""

from __future__ import annotations

import numpy as np

__all__ = ["box_union_crop", "apply_crop_to_boxes"]


def box_union_crop(frames: np.ndarray, boxes: np.ndarray):
    """Crop a clip around the union of its boxes.

    Args:
        frames: (T, H, W, C) uint8.
        boxes: (T, M, 4) raw-pixel xyxy (zero rows = absent).
    Returns:
        (cropped frames, crop_params [y1, x1, h, w]); crop_params of zeros
        means no crop was applied (degenerate/empty boxes).
    """
    h_im, w_im = frames.shape[1:3]
    flat = boxes.reshape(-1, 4)
    flat = flat[flat.sum(-1) != 0]
    if len(flat) == 0:
        return frames, np.zeros(4, np.float32)

    x1, y1 = int(flat[:, 0].min()), int(flat[:, 1].min())
    x2 = int(max(x1, flat[:, 2].max()))
    y2 = int(max(y1, flat[:, 3].max()))
    cx, cy = (x1 + x2) // 2, (y1 + y2) // 2
    w_, h_ = x2 - x1, y2 - y1
    if w_ < 5 or h_ < 5:
        return frames, np.zeros(4, np.float32)

    # grow the window until it covers >= half the frame area (ref loop)
    attempt = 0
    while h_ * w_ < h_im * w_im * 0.5 and attempt < 100:
        w_ = int(w_ * 1.2)
        h_ = int(h_ * 1.2)
        attempt += 1
    long_side = max(h_, w_)

    ny1 = max(0, cy - h_ // 2)
    nx1 = max(0, cx - w_ // 2)
    ch = min(h_im - ny1, long_side)
    cw = min(w_im - nx1, long_side)
    if ch < 1 or cw < 1:
        return frames, np.zeros(4, np.float32)

    out = frames[:, ny1 : ny1 + ch, nx1 : nx1 + cw]
    return out, np.array([ny1, nx1, ch, cw], np.float32)


def apply_crop_to_boxes(boxes: np.ndarray, crop_params: np.ndarray, resize_target: int | None = None):
    """Shift boxes into the crop frame, clip, optionally rescale to the
    model resolution (crop_boxes semantics, utils/box_ops.py:122-135)."""
    if crop_params.sum() < 1:
        return boxes
    y1, x1, ch, cw = crop_params
    out = boxes.copy()
    out[..., 0::2] -= x1
    out[..., 1::2] -= y1
    out[..., 0::2] = np.clip(out[..., 0::2], 0, cw)
    out[..., 1::2] = np.clip(out[..., 1::2], 0, ch)
    if resize_target is not None:
        out[..., 0::2] *= resize_target / cw
        out[..., 1::2] *= resize_target / ch
    return out
