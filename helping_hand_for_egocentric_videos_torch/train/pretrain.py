"""Model construction for the eval and serving entry points.

Counterpart of ``build_models`` in
``helping_hand_for_egocentric_videos_tpu/train/pretrain.py`` (only that
function: the pretraining loop comes with the train slice). The backbone
and the decoder come from the reference's checkpoints when the config
names them, else from seeded random initialisation.
"""

from __future__ import annotations

import torch

from ..core.config import ExperimentConfig
from ..models import (
    DecoderConfig,
    Lavila,
    ObjDecoder,
    timesformer_base_config,
    timesformer_large_config,
    timesformer_tiny_config,
)
from ..models.weights import convert_decoder_checkpoint, convert_lavila_checkpoint, load_torch_state_dict

__all__ = ["build_models"]


def build_models(cfg: ExperimentConfig, rng_seed: int = 0):
    """-> (lavila_cfg, backbone ``Lavila``, dec_cfg, decoder ``ObjDecoder``),
    on the CPU. A checkpoint keeps its own temporal-embedding length."""
    factory = {
        "timesformer_large": timesformer_large_config,
        "timesformer_base": timesformer_base_config,
        "timesformer_tiny": timesformer_tiny_config,
    }[cfg.model.backbone]
    lavila_cfg = factory(num_frames=cfg.data.num_frames, project_embed_dim=cfg.model.project_embed_dim)
    dec_cfg = DecoderConfig(
        num_queries=cfg.model.num_queries + 1,
        feature_dim=lavila_cfg.visual.width,
        text_width=lavila_cfg.text.width,
        embed_dim=cfg.model.project_embed_dim,
        num_frames=cfg.data.num_frames,
        patches_per_frame=lavila_cfg.visual.patches_per_frame,
        pred_traj=cfg.model.pred_traj,
    )
    if cfg.model.backbone_ckpt:
        sd = load_torch_state_dict(cfg.model.backbone_ckpt)
        if "visual.class_embedding" in sd:
            raise NotImplementedError(
                "a stock OpenAI CLIP checkpoint needs convert_openai_clip_checkpoint, which the "
                "port does not have yet (ROADMAP.md, queue A, models/weights.py)"
            )
        backbone = convert_lavila_checkpoint(sd, lavila_cfg)
    else:
        backbone = Lavila(lavila_cfg, generator=torch.Generator().manual_seed(rng_seed))
    if cfg.model.decoder_ckpt:
        decoder = convert_decoder_checkpoint(load_torch_state_dict(cfg.model.decoder_ckpt), dec_cfg)
    else:
        decoder = ObjDecoder(dec_cfg, generator=torch.Generator().manual_seed(rng_seed + 1))
    return lavila_cfg, backbone, dec_cfg, decoder
