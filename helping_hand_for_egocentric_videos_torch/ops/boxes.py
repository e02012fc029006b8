"""Bounding-box math on tensors.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/ops/boxes.py``:
cxcywh/xyxy conversion, pairwise IoU with the ``+1e-4`` union
stabiliser, generalized IoU, the L1 matching cost and boxes around masks.
No data-dependent checks (callers mask invalid boxes), fully batched over
leading dimensions. Boxes are float tensors whose last dimension is 4.

Where the JAX package clips a value that carries a gradient
(``jnp.clip``, ``jnp.maximum``), this module takes ``torch.maximum`` /
``torch.minimum``: both split the gradient of a tie evenly between the
two sides, where ``torch.clamp`` would pass all of it.
"""

from __future__ import annotations

import torch

__all__ = [
    "box_cxcywh_to_xyxy",
    "box_xyxy_to_cxcywh",
    "box_area",
    "box_iou",
    "generalized_box_iou",
    "generalized_box_iou_elementwise",
    "l1_cost_matrix",
    "masks_to_boxes",
]


def _relu(x):
    """``jnp.clip(x, min=0)`` with its gradient at a tie."""
    return torch.maximum(x, torch.zeros_like(x))


def box_cxcywh_to_xyxy(x):
    """(cx, cy, w, h) -> (x0, y0, x1, y1)."""
    xc, yc, w, h = x.unbind(-1)
    return torch.stack([xc - 0.5 * w, yc - 0.5 * h, xc + 0.5 * w, yc + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(x):
    """(x0, y0, x1, y1) -> (cx, cy, w, h)."""
    x0, y0, x1, y1 = x.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1)


def box_area(boxes):
    """Area of xyxy boxes, shape ``boxes.shape[:-1]``."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1, boxes2):
    """Pairwise IoU of xyxy boxes (..., N, 4) and (..., M, 4) ->
    (iou, union), each (..., N, M); the union gets ``+1e-4`` in the
    division, so degenerate boxes give no NaN."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = _relu(rb - lt)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / (union + 1e-4), union


def _enclosing_term(area, union):
    return (area - union) / torch.where(area == 0, torch.ones_like(area), area)


def generalized_box_iou(boxes1, boxes2):
    """Pairwise GIoU of xyxy boxes -> (..., N, M). The enclosing area's
    division is guarded against an exact zero."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = _relu(rb - lt)
    return iou - _enclosing_term(wh[..., 0] * wh[..., 1], union)


def generalized_box_iou_elementwise(boxes1, boxes2):
    """GIoU of aligned xyxy boxes (..., 4) -> (...,): the diagonal of
    ``generalized_box_iou`` without the N x N matrix."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    wh = _relu(torch.minimum(boxes1[..., 2:], boxes2[..., 2:]) - torch.maximum(boxes1[..., :2], boxes2[..., :2]))
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    iou = inter / (union + 1e-4)
    wh_e = _relu(torch.maximum(boxes1[..., 2:], boxes2[..., 2:]) - torch.minimum(boxes1[..., :2], boxes2[..., :2]))
    return iou - _enclosing_term(wh_e[..., 0] * wh_e[..., 1], union)


def l1_cost_matrix(boxes1, boxes2):
    """Pairwise L1 distance (``cdist(p=1)``): (..., N, 4), (..., M, 4) ->
    (..., N, M)."""
    return (boxes1[..., :, None, :] - boxes2[..., None, :, :]).abs().sum(-1)


def masks_to_boxes(masks):
    """xyxy boxes around binary masks (N, H, W) -> (N, 4) f32; an empty
    mask gives a zero box."""
    n, h, w = masks.shape
    m = masks.float()
    ys = torch.arange(h, dtype=torch.float32, device=m.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=m.device)[None, None, :]
    big = torch.full_like(m, 1e8)
    on = m > 0
    x_max = (m * xs).amax(dim=(1, 2))
    x_min = torch.where(on, xs * torch.ones_like(m), big).amin(dim=(1, 2))
    y_max = (m * ys).amax(dim=(1, 2))
    y_min = torch.where(on, ys * torch.ones_like(m), big).amin(dim=(1, 2))
    box = torch.stack([x_min, y_min, x_max, y_max], dim=1)
    empty = m.sum(dim=(1, 2)) == 0
    return torch.where(empty[:, None], torch.zeros_like(box), box)
