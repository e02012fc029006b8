"""DETR set criterion: Hungarian-matched L1 + GIoU box losses.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/losses/set_criterion.py``,
with the matching solved on the device (``ops/lap.py``). It keeps the
reference's quirks:

- the matching cost is 5 * L1(cxcywh) + 2 * (-GIoU), with no class cost;
- ``num_boxes`` is the number of valid target boxes, at least 1, counted
  over the global batch (``count_sum``: the sum over ranks, see
  ``parallel/dist.py``);
- ``compute_box_loss`` scales the weighted sum by 3 / 4 (the reference
  divides by 4/3, its weight dict having 4 entries); the reference's aux
  layer losses never reach its total, so no aux layer is matched here;
- targets: raw pixel xyxy clipped to [0, resize] / resize, degenerate
  boxes (x1 <= x0 or y1 <= y0) masked out;
- queries 0:2 are hands and 2:``num_queries`` objects.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.boxes import (
    box_cxcywh_to_xyxy,
    box_xyxy_to_cxcywh,
    generalized_box_iou,
    generalized_box_iou_elementwise,
    l1_cost_matrix,
)
from ..ops.lap import solve_lap_batch

__all__ = ["MatchCosts", "prepare_targets", "box_set_loss", "compute_box_loss"]


@dataclass(frozen=True)
class MatchCosts:
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    weight_bbox: float = 5.0
    weight_giou: float = 2.0
    total_scale: float = 0.75  # 3 / len(weight_dict)


def prepare_targets(boxes_xyxy, resize: float = 224.0):
    """(B, M, 4) pixel xyxy boxes (zero rows absent) -> (targets cxcywh in
    [0, 1] (B, M, 4), valid (B, M) bool)."""
    b = boxes_xyxy.clamp(0.0, resize) / resize
    valid = (b[..., 2] > b[..., 0]) & (b[..., 3] > b[..., 1])
    return box_xyxy_to_cxcywh(b), valid


def _match(pred_boxes, target_boxes, target_valid, costs: MatchCosts):
    """(B, Q, 4), (B, M, 4) cxcywh, (B, M) -> target_to_pred (B, M) int32."""
    with torch.no_grad():
        cost_l1 = l1_cost_matrix(pred_boxes, target_boxes)
        cost_giou = -generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes), box_cxcywh_to_xyxy(target_boxes))
        cost = costs.cost_bbox * cost_l1 + costs.cost_giou * cost_giou
        t2p, _ = solve_lap_batch(cost, target_valid)
    return t2p


def box_set_loss(pred_boxes, target_boxes, target_valid, costs: MatchCosts = MatchCosts(), num_boxes=None,
                 count_sum=None):
    """Matched L1 + GIoU losses.

    Args:
        pred_boxes: (B, Q, 4) sigmoid cxcywh predictions.
        target_boxes: (B, M, 4) cxcywh in [0, 1]; target_valid (B, M).
        num_boxes: the normaliser; default max(#valid, 1), where #valid
            is ``count_sum`` of this batch's count when given (the count
            over every rank's batch).
    Returns:
        dict(loss_bbox, loss_giou, num_boxes, target_to_pred).
    """
    q = pred_boxes.shape[1]
    t2p = _match(pred_boxes, target_boxes, target_valid, costs)
    idx = t2p.clamp(0, q - 1).long()[..., None].expand(-1, -1, 4)
    matched = pred_boxes.gather(1, idx)  # (B, M, 4)
    w = (target_valid & (t2p >= 0)).to(pred_boxes.dtype)[..., None]
    if num_boxes is None:
        count = w.sum()
        num_boxes = (count if count_sum is None else count_sum(count)).clamp_min(1.0)
    l1 = ((matched - target_boxes).abs() * w).sum() / num_boxes
    giou = generalized_box_iou_elementwise(box_cxcywh_to_xyxy(matched), box_cxcywh_to_xyxy(target_boxes))
    giou_loss = ((1.0 - giou) * w[..., 0]).sum() / num_boxes
    return {"loss_bbox": l1, "loss_giou": giou_loss, "num_boxes": num_boxes, "target_to_pred": t2p}


_QUERIES = ("hand_boxes", "obj_boxes", "all_boxes")


def compute_box_loss(box_type: str, pred_boxes, target_boxes_xyxy, costs: MatchCosts = MatchCosts(),
                     num_queries: int = 12, resize: float = 224.0, count_sum=None):
    """The reference-weighted loss of one box family.

    Args:
        box_type: 'hand_boxes' (queries 0:2), 'obj_boxes' (queries
            2:num_queries) or 'all_boxes'.
        pred_boxes: (B', Q, 4) decoder boxes (B' = B*T with per-frame boxes).
        target_boxes_xyxy: (B', M, 4) raw pixel boxes.
        count_sum: the sum over ranks of the valid-box count (None: one
            process); the loss is then this rank's share of the global one.
    Returns:
        (scalar loss, the ``box_set_loss`` dict).
    """
    if box_type == "hand_boxes":
        pred = pred_boxes[:, 0:2]
    elif box_type == "obj_boxes":
        pred = pred_boxes[:, 2:num_queries]
    elif box_type == "all_boxes":
        pred = pred_boxes
    else:
        raise ValueError(f"box_type must be one of {_QUERIES}, got {box_type!r}")
    tgt, valid = prepare_targets(target_boxes_xyxy, resize=resize)
    out = box_set_loss(pred, tgt, valid, costs, count_sum=count_sum)
    total = (costs.weight_bbox * out["loss_bbox"] + costs.weight_giou * out["loss_giou"]) * costs.total_scale
    return total, out
