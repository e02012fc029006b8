"""Word-level contrastive loss: object queries against ground-truth nouns.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/losses/word_contrastive.py``:
per sample, Hungarian-match the (at most 4) ground-truth noun embeddings
to the predicted object-query embeddings by cosine similarity (on the
device, without gradient), then cross-entropy each matched prediction
against the whole noun dictionary. Nouns too similar to the ground truth
(> ``noun_threshold``) get a logit of -1 before the temperature. Noun id
0 is padding: it is left out of the matching and of the mean.
"""

from __future__ import annotations

import torch

from ..metrics.sim import sim_matrix
from ..ops.lap import solve_lap_batch

__all__ = ["word_contrastive_loss"]


def word_contrastive_loss(noun_embeds, pred_noun_embeds, noun_gt_inds, temperature: float = 0.07,
                          noun_threshold: float = 0.6, count_sum=None):
    """Args:
        noun_embeds: (V, E) projected noun-dictionary embeddings.
        pred_noun_embeds: (B, Q_obj, E) projected object-query states.
        noun_gt_inds: (B, M) int noun ids; 0 is padding.
        count_sum: the sum over ranks of the valid-slot count (None: one
            process); the loss is then this rank's share of the global mean.
    Returns:
        the mean cross-entropy over the valid noun slots (a scalar).
    """
    b, m = noun_gt_inds.shape
    flat = noun_gt_inds.reshape(-1).long()
    valid = noun_gt_inds != 0

    gt = noun_embeds.index_select(0, flat).reshape(b, m, -1)  # (B, M, E)
    with torch.no_grad():  # targets (nouns) as columns: cost (B, Q, M)
        cost = (-sim_matrix(gt, pred_noun_embeds)).transpose(1, 2)
        t2p, _ = solve_lap_batch(cost, valid)

    q = pred_noun_embeds.shape[1]
    idx = t2p.clamp(0, q - 1).long()[..., None].expand(-1, -1, pred_noun_embeds.shape[-1])
    sel = pred_noun_embeds.gather(1, idx)  # (B, M, E)
    sim_all = sim_matrix(sel.reshape(b * m, -1), noun_embeds)  # (B*M, V)

    noun_sim = sim_matrix(noun_embeds, noun_embeds)
    v = noun_sim.shape[0]
    noun_sim = noun_sim * (1.0 - torch.eye(v, dtype=noun_sim.dtype, device=noun_sim.device))
    noun_mask = noun_sim.index_select(0, flat) > noun_threshold  # (B*M, V)

    logp = torch.log_softmax(torch.where(noun_mask, -1.0, sim_all) / temperature, dim=-1)
    ce = -logp.gather(1, flat[:, None])[:, 0]
    vmask = valid.reshape(-1).to(ce.dtype)
    count = vmask.sum()
    return (ce * vmask).sum() / (count if count_sum is None else count_sum(count)).clamp_min(1.0)
