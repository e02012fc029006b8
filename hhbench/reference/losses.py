"""The pretraining objective in plain float32, with the matchings solved
by ``scipy.optimize.linear_sum_assignment`` on the host.

- EgoNCE with R captions a clip (rows clip-major): positives are the
  caption's own clip plus the clips whose verb and noun tag similarities
  are both non-zero; a caption of two non-zero tokens (an empty one) is
  left out of both directions.
- The set criterion for the hand queries (0:2) and the object queries
  (2:num_queries) on per-frame boxes: targets clipped to the frame and
  scaled to [0, 1], degenerate ones left out; the matching minimises
  5 * L1 + 2 * (-GIoU) over cxcywh boxes; the loss is
  (5 * L1 + 2 * (1 - GIoU)) / max(#matched, 1), times 3 / 4.
- The word-level contrastive loss: each non-padding ground-truth noun is
  matched to an object-query embedding by cosine; each matched embedding
  is classified over the whole noun dictionary, with the nouns too close
  (cosine > 0.6) to the ground truth given the logit -1; temperature 0.07.
- total = EgoNCE + box + 0.5 * word.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


def cosine(a, b, eps=1e-8):
    a = a / a.norm(dim=-1, keepdim=True).clamp_min(eps)
    b = b / b.norm(dim=-1, keepdim=True).clamp_min(eps)
    return a @ b.transpose(-1, -2)


def egonce(sim, sim_v, sim_n, pad_rows, temperature):
    rn, n = sim.shape
    r = rn // n
    valid = pad_rows > 0
    pos = ((sim_v * sim_n).repeat_interleave(r, dim=0) + torch.eye(n, device=sim.device).repeat_interleave(r, dim=0)) > 0
    pos = pos & valid[:, None]
    logp_t2v = torch.log_softmax(sim / temperature, dim=1)
    per_row = (logp_t2v * pos).sum(1) / pos.sum(1).clamp_min(1)
    loss_t2v = per_row[valid].sum() / valid.sum().clamp_min(1)
    logits = (sim / temperature).masked_fill(~valid[:, None], float("-inf"))
    logp_v2t = torch.log_softmax(logits, dim=0).masked_fill(~valid[:, None], 0.0)
    loss_v2t = ((logp_v2t * pos).sum(0) / pos.sum(0).clamp_min(1)).mean()
    return -loss_t2v - loss_v2t


def _xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _giou(a, b):
    """Pairwise GIoU of xyxy boxes (N, 4), (M, 4) -> (N, M), with the
    ``+1e-4`` on the union of the published code."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.max(a[:, None, :2], b[None, :, :2])
    rb = torch.min(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    union = area_a[:, None] + area_b[None, :] - inter
    iou = inter / (union + 1e-4)
    lt_e = torch.min(a[:, None, :2], b[None, :, :2])
    rb_e = torch.max(a[:, None, 2:], b[None, :, 2:])
    area_e = (rb_e - lt_e).clamp(min=0).prod(-1)
    return iou - (area_e - union) / torch.where(area_e == 0, torch.ones_like(area_e), area_e)


def box_family_loss(pred, target_xyxy_px, resize):
    """pred (B', Qf, 4) cxcywh; targets (B', M, 4) pixel xyxy -> loss."""
    tgt = target_xyxy_px.clamp(0.0, resize) / resize
    valid = (tgt[..., 2] > tgt[..., 0]) & (tgt[..., 3] > tgt[..., 1])
    tgt_c = torch.stack([(tgt[..., 0] + tgt[..., 2]) / 2, (tgt[..., 1] + tgt[..., 3]) / 2,
                         tgt[..., 2] - tgt[..., 0], tgt[..., 3] - tgt[..., 1]], -1)
    rows_p, rows_t = [], []
    with torch.no_grad():
        cost_all = (5.0 * torch.cdist(pred, tgt_c, p=1) - 2.0 * torch.stack(
            [_giou(_xyxy(pred[i]), _xyxy(tgt_c[i])) for i in range(pred.shape[0])])).cpu().numpy()
    valid_np = valid.cpu().numpy()
    for i in range(pred.shape[0]):
        cols = np.nonzero(valid_np[i])[0]
        if len(cols) == 0:
            continue
        pi, ti = linear_sum_assignment(cost_all[i][:, cols])
        rows_p += [(i, p) for p in pi]
        rows_t += [(i, cols[t]) for t in ti]
    if not rows_p:
        return pred.sum() * 0.0
    bi = torch.tensor([r[0] for r in rows_p], device=pred.device)
    pq = torch.tensor([r[1] for r in rows_p], device=pred.device)
    tq = torch.tensor([r[1] for r in rows_t], device=pred.device)
    mp, mt = pred[bi, pq], tgt_c[bi, tq]
    num = float(len(rows_p))
    l1 = (mp - mt).abs().sum() / num
    a, b = _xyxy(mp), _xyxy(mt)
    giou = torch.diagonal(_giou(a, b)) if len(a) else a.sum()
    giou_loss = (1.0 - giou).sum() / num
    return (5.0 * l1 + 2.0 * giou_loss) * 0.75


def word_loss(noun_embeds, pred_embeds, noun_ids, temperature, threshold=0.6):
    """noun_embeds (V, E); pred_embeds (B, Q, E); noun_ids (B, M), 0 = padding."""
    b, m = noun_ids.shape
    with torch.no_grad():
        cost = (-cosine(noun_embeds[noun_ids], pred_embeds)).cpu().numpy()  # (B, M, Q)
    ids = noun_ids.cpu().numpy()
    sel_b, sel_q, sel_n = [], [], []
    for i in range(b):
        rows = np.nonzero(ids[i] != 0)[0]
        if len(rows) == 0:
            continue
        ti, pi = linear_sum_assignment(cost[i][rows])
        sel_b += [i] * len(ti)
        sel_q += list(pi)
        sel_n += [int(ids[i, rows[t]]) for t in ti]
    if not sel_b:
        return pred_embeds.sum() * 0.0
    dev = pred_embeds.device
    sel = pred_embeds[torch.tensor(sel_b, device=dev), torch.tensor(sel_q, device=dev)]
    gt = torch.tensor(sel_n, device=dev)
    sim_all = cosine(sel, noun_embeds)
    noun_sim = cosine(noun_embeds, noun_embeds) * (1.0 - torch.eye(noun_embeds.shape[0], device=dev))
    logits = torch.where(noun_sim[gt] > threshold, -1.0, sim_all) / temperature
    return torch.nn.functional.cross_entropy(logits, gt)


def pretrain_loss(wd, dec_cfg, train_cfg, grid, text_fmap, batch, noun_dict, gen=None, mm=torch.nn.functional.linear):
    """-> (total loss, dict of its terms). ``wd``: the decoder's weights
    (tensors that require grad); ``grid`` (N, T, P, C) and ``text_fmap``
    (N*R, 77, W) float32 backbone outputs; ``batch``: the step's inputs.
    ``gen``: the dropout generator (None: no dropout); ``mm``: the matrix
    product of the decoder's linear layers and projections."""
    from .model import decoder, obj_proj, txt_proj

    hs, boxes = decoder(wd, dec_cfg, grid, gen=gen, mm=mm)
    tokens = batch["tokens"]
    eot = tokens.argmax(dim=-1)
    text = txt_proj(wd, text_fmap[torch.arange(tokens.shape[0], device=tokens.device), eot], mm=mm)
    last = obj_proj(wd, hs[-1], mm=mm)
    video = last[:, -1]
    temp = train_cfg["temperature"]
    sim = cosine(text, video)
    pad_rows = ((tokens != 0).sum(-1) != 2).float()
    nce = egonce(sim, cosine(batch["verb_vec"], batch["verb_vec"]), cosine(batch["noun_vec"], batch["noun_vec"]),
                 pad_rows, temp)
    n, t = grid.shape[:2]
    res = float(train_cfg["resize"])
    nq = train_cfg["num_queries"]
    bx = batch["boxes"]
    box = (box_family_loss(boxes[:, 0:2], bx[:, :, :2].reshape(n * t, 2, 4), res)
           + box_family_loss(boxes[:, 2:nq], bx[:, :, 2:].reshape(n * t, -1, 4), res))
    word = word_loss(txt_proj(wd, noun_dict, mm=mm), last[:, :-1], batch["nouns"], temp)
    total = nce + box + train_cfg["word_loss_weight"] * word
    return total, {"nce": nce.detach(), "box": box.detach(), "word": word.detach()}
