"""Device-side similarity and training-accuracy helpers.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/metrics/sim.py``:
``sim_matrix`` is the cosine similarity with an epsilon-floored norm, and
``compute_tv_accuracy`` the top-1 accuracy under the EgoNCE positive mask
that pretraining logs. Matrix products run in full f32 (TF32 off, the
PyTorch default for matmuls).
"""

from __future__ import annotations

import torch

__all__ = ["sim_matrix", "compute_tv_accuracy"]


def _normalize(a, eps: float):
    n = torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    return a / torch.maximum(n, torch.full_like(n, eps))


def sim_matrix(a, b, eps: float = 1e-8, norm: bool = True):
    """Cosine (or, with ``norm=False``, dot-product) similarity: (N, D) x
    (M, D) -> (N, M); 3-D inputs are batched, (B, N, D) x (B, M, D)."""
    if norm:
        a = _normalize(a, eps)
        b = _normalize(b, eps)
    return a @ b.transpose(-1, -2)


def _eye(n: int, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def compute_tv_accuracy(similarity, text_embeds, sim_v, sim_n, num_samples: int, rephrase_factor: int = 5):
    """Top-1 video<->text accuracy under the EgoNCE positive mask.

    Args:
        similarity: (N, N) similarity of each video's first caption to
            every video.
        text_embeds: (N * rephrase_factor, D); every
            ``rephrase_factor``-th row is a primary caption.
        sim_v / sim_n: (N, N) verb / noun tag similarity.
        num_samples: N.
    Returns:
        (acc_vt, acc_tv), f32 scalars in [0, 1].
    """
    tv_argmax = similarity.argmax(dim=-1)
    vt_argmax = similarity.argmax(dim=0)

    primaries = text_embeds[::rephrase_factor]
    eye = _eye(num_samples, similarity)
    same_neg = (sim_matrix(primaries, primaries) > 0.99).to(similarity.dtype) * (1.0 - eye)
    pos_mask = ((sim_v * sim_n) + eye + same_neg) > 0

    rows = torch.arange(num_samples, device=similarity.device)
    vt_onehot = rows[:, None] == vt_argmax[None, :]  # one_hot(vt_argmax, axis=0)
    acc_vt = ((vt_onehot & pos_mask).sum(0) > 0).float().mean()
    tv_onehot = tv_argmax[:, None] == rows[None, :]
    acc_tv = ((tv_onehot & pos_mask).sum(-1) > 0).float().mean()
    return acc_vt, acc_tv
