"""EgoNCE: symmetric InfoNCE with verb/noun-aware positives.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/losses/egonce.py``:

- single-positive: positives = (verb-sim * noun-sim) + diagonal;
- multi-positive (the training path): each video has R rephrased captions,
  rows sample-major (row = video * R + r); padded captions (empty strings)
  are masked out row-wise. Positives = (verb-sim * noun-sim + the
  caption's own video) * pad mask.

Shapes stay fixed: a padded row is masked inside the normalised sums
instead of dropped, which gives the same loss (it adds 0 to the
text->video term, and its entries leave every column softmax of the
video->text term).
"""

from __future__ import annotations

import torch

__all__ = ["egonce_loss", "egonce_multi_positive_loss"]

_NEG = -1e9


def _masked_log_softmax(logits, valid, dim: int):
    """log_softmax over ``dim`` restricted to ``valid`` entries."""
    return torch.log_softmax(torch.where(valid, logits, _NEG), dim=dim)


def _eye(n: int, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _repeat_rows(x, r: int):
    """(N, M) -> (N * R, M), row i*R + k a copy of row i."""
    n, m = x.shape
    return x[:, None, :].expand(n, r, m).reshape(n * r, m)


def egonce_loss(sim, mask_v=None, mask_n=None, temperature: float = 0.07):
    """Single-positive EgoNCE on a square (N, N) similarity -> (loss,
    positives mask (N, N) bool)."""
    eye = _eye(sim.shape[0], sim)
    if mask_v is not None and mask_n is not None:
        mask = mask_v * mask_n + eye
    elif mask_n is not None:
        mask = mask_n + eye
    elif mask_v is not None:
        mask = mask_v + eye
    else:
        mask = eye
    mask_bool = mask > 0

    i_sm = torch.log_softmax(sim / temperature, dim=1)
    loss_i = ((i_sm * mask_bool).sum(1) / mask_bool.sum(1)).mean()
    j_sm = torch.log_softmax(sim.T / temperature, dim=1)
    loss_j = ((j_sm * mask_bool.T).sum(1) / mask_bool.sum(0)).mean()
    return -loss_i - loss_j, mask_bool


def egonce_multi_positive_loss(sim, mask_v, mask_n, pad_mask, temperature: float = 0.07,
                               vn_threshold: float = 0.0):
    """Multi-positive EgoNCE.

    Args:
        sim: (R*N, N) text->video similarity, rows sample-major.
        mask_v / mask_n: (N, N) verb / noun tag similarity, or None.
        pad_mask: (R*N,) or (R*N, N); 0 marks a padded caption (constant
            along a row).
    Returns:
        (loss, positives mask (R*N, N) bool).
    """
    rn, n = sim.shape
    r = rn // n
    row_valid = (pad_mask[:, 0] if pad_mask.dim() == 2 else pad_mask) > 0
    pad2d = row_valid[:, None].expand(rn, n).to(sim.dtype)

    multi_pos = _repeat_rows(_eye(n, sim), r)
    if mask_v is not None and mask_n is not None:
        mask = (_repeat_rows(mask_v * mask_n, r) + multi_pos) * pad2d
    elif mask_n is not None:
        mask = (_repeat_rows(mask_n, r) + multi_pos) * pad2d
    elif mask_v is not None:
        mask = (_repeat_rows(mask_v, r) + multi_pos) * pad2d
    else:
        mask = multi_pos * pad2d
    mask_bool = mask > vn_threshold

    # text -> video (rows): softmax over videos; only valid rows count
    i_sm = torch.log_softmax(sim / temperature, dim=1)
    idiag = (i_sm * mask_bool).sum(1) / mask_bool.sum(1).clamp_min(1)
    loss_i = torch.where(row_valid, idiag, 0.0).sum() / row_valid.sum().clamp_min(1)

    # video -> text (columns): softmax over the valid text rows
    j_sm = _masked_log_softmax(sim / temperature, row_valid[:, None], dim=0)
    loss_j = ((j_sm * mask_bool).sum(0) / mask_bool.sum(0).clamp_min(1)).mean()
    return -loss_i - loss_j, mask_bool
