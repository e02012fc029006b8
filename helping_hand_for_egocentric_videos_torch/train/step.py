"""Pretraining step: frozen backbone -> object decoder -> combined loss -> AdamW.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/train/step.py``.
One step of the reference's training iteration:

1. the frozen LaviLa forward (bf16 by default) under ``torch.no_grad``,
   its divided attention in the CUDA kernels K1/K2 on the card;
2. the object decoder on the (B, T, N, C) patch grid, cast to f32;
3. EgoNCE over the batch's similarity matrix;
4. Hungarian box losses for the hand (queries 0:2) and object
   (2:num_queries) families on per-frame boxes, matched on the device;
5. the word-level contrastive loss (x0.5);
6. AdamW on the decoder only, with the reference's decay policy.

Nothing in the step waits for the device: the matchings run as tensor
operations, the augmentation draws on the device, and every metric stays
a device tensor until the caller reads it.

With a ``parallel.DataParallel`` (``dist``), each rank runs the step on
its rows of the global batch: EgoNCE on the all-gathered embeddings, the
box and word losses normalised by counts summed over ranks, the
gradients averaged. Each term is scaled so that the averaged gradient is
the one-process gradient of the global batch, and the metrics are the
global batch's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple

import torch

from ..device import resolve_device
from ..losses import compute_box_loss, egonce_multi_positive_loss, word_contrastive_loss
from ..metrics.sim import compute_tv_accuracy, sim_matrix
from ..models.lavila import lavila_forward
from ..models.obj_decoder import DecoderConfig, ObjDecoder, decoder_forward, obj_proj, txt_proj
from ..ops.preprocess import apply_augment, augment_rows, resize_normalize, sample_augment_params, transform_boxes

__all__ = [
    "TrainConfig",
    "TrainState",
    "backbone_features",
    "learning_rate",
    "make_optimizer",
    "make_train_step",
    "pretrain_loss_and_metrics",
]

FROZEN = ("class_embed", "vid_proj")  # no update and no decay: the loss never reads them


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-5
    wd: float = 1e-5
    b1: float = 0.9
    b2: float = 0.999
    temperature: float = 0.07
    word_loss_weight: float = 0.5
    clip_grad: float = 0.0  # global-norm clip; 0 disables (the reference never clips)
    rephrase_factor: int = 5
    resize: float = 224.0  # the pixel normaliser of the box targets
    input_res: int = 224  # device-side preprocess target of uint8 video
    num_queries: int = 12  # hand and object queries (the summary query excluded)
    backbone_dtype: torch.dtype = torch.bfloat16
    # train-time random augmentation (data_loader/transforms.py:64-69); off in
    # the reference's shipped command (force_centercrop=True)
    augment: bool = False
    randcrop_scale: tuple = (0.5, 1.0)
    color_jitter: tuple = (0.0, 0.0, 0.0)  # brightness, saturation, hue
    # "constant" (the reference's LR) or "warmup_cosine": linear warmup over
    # warmup_steps, then cosine decay to 0 at total_steps
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 0


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """The LR of update ``count`` (0 for the first): ``cfg.lr``, or optax's
    ``warmup_cosine_decay_schedule(0, lr, max(warmup_steps, 1),
    total_steps)`` with its formulas."""
    if cfg.schedule == "constant":
        return cfg.lr
    warm = max(cfg.warmup_steps, 1)
    if count < warm:  # linear from 0 to lr
        frac = 1 - min(max(count, 0), warm) / warm
        return -cfg.lr * frac + cfg.lr
    decay = cfg.total_steps - warm
    c = min(count - warm, decay)
    return cfg.lr * (0.5 * (1 + math.cos(math.pi * c / decay)))


def _decays(name: str) -> bool:
    """Weights, LayerNorm scales and embeddings decay; biases do not,
    except the q/k/v in-projection biases: the reference's optimizer policy
    matches names containing ``.bias``, and torch names the packed q/k/v
    bias ``in_proj_bias``."""
    parts = name.split(".")
    return parts[-1] != "bias" or any(k in ("wq", "wk", "wv") for k in parts)


def make_optimizer(cfg: TrainConfig, decoder: ObjDecoder):
    """AdamW on the decoder -> (optimizer, schedule).

    Two groups, ``"decay"`` (weight decay ``cfg.wd``) and ``"no_decay"``,
    each with its parameter names under ``"names"``. ``class_embed`` and
    ``vid_proj`` are in neither: they get no update and no decay. The
    schedule maps the step count to the LR (``learning_rate``); the step
    sets it before each update. The update is optax's ``adamw`` (eps
    1e-8), whose decay also multiplies the parameter before the update.
    """
    if cfg.schedule == "warmup_cosine":
        if cfg.total_steps <= 0:
            raise ValueError("schedule='warmup_cosine' needs total_steps > 0")
        if cfg.total_steps <= max(cfg.warmup_steps, 1):
            raise ValueError("schedule='warmup_cosine' needs total_steps > max(warmup_steps, 1)")
    elif cfg.schedule != "constant":
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    groups = {"decay": ([], []), "no_decay": ([], [])}
    for name, p in decoder.named_parameters():
        if name.split(".")[0] in FROZEN:
            continue
        names, params = groups["decay" if _decays(name) else "no_decay"]
        names.append(name)
        params.append(p)
    optimizer = torch.optim.AdamW(
        [{"params": groups["decay"][1], "weight_decay": cfg.wd, "group": "decay", "names": groups["decay"][0]},
         {"params": groups["no_decay"][1], "weight_decay": 0.0, "group": "no_decay",
          "names": groups["no_decay"][0]}],
        lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=1e-8,
    )
    return optimizer, partial(learning_rate, cfg)


class TrainState(NamedTuple):
    decoder: ObjDecoder
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int

    @classmethod
    def create(cls, decoder: ObjDecoder, cfg: TrainConfig, *, device=None) -> "TrainState":
        """The decoder moved to ``device`` (None: the CUDA device, raising
        without one; pass ``device="cpu"`` for the CPU), its optimizer and
        schedule, step 0."""
        decoder = decoder.to(resolve_device(device))
        return cls(decoder, *make_optimizer(cfg, decoder), 0)


def backbone_features(backbone, lavila_cfg, video, tokens, *, dtype=torch.bfloat16):
    """The frozen backbone's forward under ``torch.no_grad``: the decoder's
    inputs, with no gradient.

    video: (Bv, T, H, W, C) normalised; tokens: (Bt, 77).
    Returns (video_grid (Bv, T, N, C), text_fmap (Bt, 77, Wt)), f32.
    """
    with torch.no_grad():
        out = lavila_forward(backbone, lavila_cfg, video, tokens, dtype=dtype)
    bv, t = video.shape[:2]
    grid = out["image_feature_map"][:, 1:, :].reshape(bv, t, lavila_cfg.visual.patches_per_frame, -1)
    return grid, out["text_feature_map"]


def pretrain_loss_and_metrics(decoder: ObjDecoder, dec_cfg: DecoderConfig, cfg: TrainConfig, video_grid, text_fmap,
                              tokens, noun_vec, verb_vec, boxes, noun_gt_inds, noun_dict_embeds, generator=None,
                              dist=None):
    """The training loss on backbone features -> (objective, metrics).

    Shapes: video_grid (N_v, T, N, C); text_fmap (N_v*R, 77, Wt); tokens
    (N_v*R, 77); noun_vec (N_v, V_n); verb_vec (N_v, V_v); boxes (N_v, T,
    4, 4) pixel xyxy, slots [hand0, hand1, obj0, obj1]; noun_gt_inds (N_v,
    M); noun_dict_embeds (V, Wt). ``generator``: dropout in the decoder.
    The metrics (``total_loss``, ``nce_loss``, ``box_loss``, ``word_loss``,
    ``top1_video_to_text``, ``top1_text_to_video``) are detached device
    tensors.

    One process: the objective is ``total_loss``. With ``dist`` (a
    ``parallel.DataParallel``) the inputs are this rank's rows. EgoNCE
    runs on the gathered embeddings, whole on every rank; the gather's
    backward sums its gradient over the W ranks, so each rank's EgoNCE
    gradient is W times its rows' share. The box and word losses are this
    rank's share of the global ones (counts summed over ranks) and enter
    the objective times W. Averaged over ranks, the gradient is then the
    one-process gradient; the metrics are the global batch's.
    """
    n_videos, t = video_grid.shape[:2]
    out = decoder_forward(decoder, dec_cfg, video_grid, generator=generator, deterministic=generator is None)

    eot = tokens.argmax(dim=-1)
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    text_embeds = txt_proj(decoder, text_fmap[rows, eot])
    last = obj_proj(decoder, out.hs[-1])
    video_embeds = last[:, -1]
    count_sum = None if dist is None else dist.sum
    if dist is not None:  # EgoNCE over the global batch
        text_embeds, video_embeds = dist.gather(text_embeds), dist.gather(video_embeds)
        tokens, verb_vec, noun_vec = (dist.gather_const(x) for x in (tokens, verb_vec, noun_vec))
    n_global = video_embeds.shape[0]

    # EgoNCE over the batch
    sim = sim_matrix(text_embeds, video_embeds)  # (N_v*R, N_v)
    sim_v = sim_matrix(verb_vec, verb_vec)
    sim_n = sim_matrix(noun_vec, noun_vec)
    pad_rows = ((tokens != 0).sum(-1) != 2).float()
    nce_loss, _ = egonce_multi_positive_loss(sim, sim_v, sim_n, pad_rows, temperature=cfg.temperature)

    # box losses on per-frame predictions
    hand = boxes[:, :, :2, :].reshape(n_videos * t, 2, 4)
    obj = boxes[:, :, 2:, :].reshape(n_videos * t, -1, 4)
    kw = {"num_queries": cfg.num_queries, "resize": cfg.resize, "count_sum": count_sum}
    loss_hand, _ = compute_box_loss("hand_boxes", out.pred_boxes, hand, **kw)
    loss_obj, _ = compute_box_loss("obj_boxes", out.pred_boxes, obj, **kw)
    box_loss = loss_hand + loss_obj

    # word contrastive
    noun_embeds = txt_proj(decoder, noun_dict_embeds)
    word_loss = word_contrastive_loss(noun_embeds, last[:, :-1], noun_gt_inds, temperature=cfg.temperature,
                                      count_sum=count_sum)

    local = box_loss + cfg.word_loss_weight * word_loss
    if dist is None:
        objective = nce_loss + local
    else:
        objective = nce_loss + dist.world * local
        box_loss, word_loss = dist.sum(box_loss), dist.sum(word_loss)
    total = nce_loss + box_loss + cfg.word_loss_weight * word_loss

    with torch.no_grad():  # train-time accuracy on the primary captions
        r = cfg.rephrase_factor
        sim_primary = sim.reshape(n_global, r, n_global)[:, 0, :]
        acc_vt, acc_tv = compute_tv_accuracy(sim_primary, text_embeds, sim_v, sim_n, n_global, rephrase_factor=r)
    metrics = {
        "total_loss": total.detach(),
        "nce_loss": nce_loss.detach(),
        "box_loss": box_loss.detach(),
        "word_loss": word_loss.detach(),
        "top1_video_to_text": acc_vt,
        "top1_text_to_video": acc_tv,
    }
    return objective, metrics


def _global_norm(tensors):
    return torch.sqrt(sum((g * g).sum() for g in tensors))


def augment_batch(cfg: TrainConfig, video, boxes, generator, dist=None):
    """The step's train-time augmentation of uint8 clips -> (normalised
    video, boxes in the augmented frames). The parameters are drawn from
    ``generator`` for the global batch, so every rank draws the same ones
    and keeps its own rows: a W-rank step augments as the one-process step
    of the same global batch does."""
    if video.dtype != torch.uint8:
        raise ValueError(
            "augment=True needs raw uint8 video (the augmentation crops and normalises on the device); "
            f"got {video.dtype}: feed decoded frames, not preprocessed floats"
        )
    b, _, h, w, _ = video.shape
    n_global = b if dist is None else b * dist.world
    bj, sj, hj = cfg.color_jitter
    params = sample_augment_params(generator, n_global, h, w, scale=cfg.randcrop_scale, brightness=bj,
                                   saturation=sj, hue=hj, device=video.device)
    if dist is not None:
        params = augment_rows(params, dist.rows(n_global))
    video = apply_augment(video, params, cfg.input_res)
    return video, transform_boxes(boxes, params, res=cfg.input_res, coords_res=cfg.input_res)


def make_train_step(dec_cfg: DecoderConfig, lavila_cfg, cfg: TrainConfig, *, dist=None):
    """Build the train step.

    ``step(state, backbone, batch, noun_dict_embeds, generator=None, *,
    aug_generator=None) -> (state, metrics)``. ``batch`` keys: video
    ((B, T, H, W, C), uint8 or normalised float), tokens, noun_vec,
    verb_vec, boxes, nouns (see ``pretrain_loss_and_metrics``); arrays or
    tensors, moved to the decoder's device (the backbone must be there).
    ``generator`` (on that device) turns dropout on. With ``cfg.augment``
    the uint8 clips are augmented on the device (``augment_batch``), the
    parameters drawn from ``aug_generator``, else from ``generator``, else
    from a generator seeded with the step count (deterministic, as the JAX
    step's ``fold_in(PRNGKey(0), step)``). The decoder's parameters are
    updated in place, each ``.grad`` holds the gradient the update used,
    and the returned state counts one more step. ``metrics`` adds
    ``grad_norm``, the global norm of the decoder's gradients before any
    clipping.

    ``dist``: a ``parallel.DataParallel``; ``batch`` is then this rank's
    rows of the global batch, and the update is the one-process update of
    the global batch (``pretrain_loss_and_metrics``).
    """

    def step(state: TrainState, backbone, batch, noun_dict_embeds, generator=None, *, aug_generator=None):
        decoder, optimizer = state.decoder, state.optimizer
        dev = next(decoder.parameters()).device
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        video, boxes = b["video"], b["boxes"]
        if cfg.augment:
            gen = aug_generator if aug_generator is not None else generator
            if gen is None:
                gen = torch.Generator(device=dev).manual_seed(state.step)
            video, boxes = augment_batch(cfg, video, boxes, gen, dist)
        elif video.dtype == torch.uint8:  # device-side preprocess
            video = resize_normalize(video, cfg.input_res)
        video_grid, text_fmap = backbone_features(backbone, lavila_cfg, video, b["tokens"],
                                                  dtype=cfg.backbone_dtype)

        optimizer.zero_grad(set_to_none=True)
        loss, metrics = pretrain_loss_and_metrics(
            decoder, dec_cfg, cfg, video_grid.float(), text_fmap.float(), b["tokens"], b["noun_vec"],
            b["verb_vec"], boxes, b["nouns"], torch.as_tensor(noun_dict_embeds, device=dev),
            generator=generator, dist=dist,
        )
        loss.backward()
        if dist is not None:
            dist.average_grads(decoder.parameters())
        grads = [p.grad for p in decoder.parameters() if p.grad is not None]
        metrics["grad_norm"] = _global_norm(grads)
        if cfg.clip_grad > 0:  # optax's clip_by_global_norm over the trained parameters
            trained = [p.grad for g in optimizer.param_groups for p in g["params"] if p.grad is not None]
            norm = _global_norm(trained)
            for g in trained:
                g.copy_(torch.where(norm < cfg.clip_grad, g, g / norm * cfg.clip_grad))
        lr = state.schedule(state.step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        return state._replace(step=state.step + 1), metrics

    return step
