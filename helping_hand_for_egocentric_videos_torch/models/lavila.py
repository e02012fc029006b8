"""LaviLa dual-encoder backbone: TimeSformer visual tower + CLIP text tower.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/models/lavila.py``.
Factories:
- ``timesformer_large_config()``: ViT-L/14 inflation, width 1024 / depth 24
  / heads 16 visual, width 768 / 12-layer text.
- ``timesformer_base_config()``: ViT-B/16, width 768 / depth 12 / heads 12
  visual, width 512 text.
- ``timesformer_tiny_config()``: a miniature for tests (no released weights).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch
from torch import nn

from .clip_text import TextConfig, TextTransformer, encode_text
from .spacetime_vit import SpaceTimeConfig, SpaceTimeViT, spacetime_forward

__all__ = [
    "LavilaConfig",
    "Lavila",
    "timesformer_large_config",
    "timesformer_base_config",
    "timesformer_tiny_config",
    "encode_image",
    "lavila_forward",
]


@dataclass(frozen=True)
class LavilaConfig:
    visual: SpaceTimeConfig = field(default_factory=SpaceTimeConfig)
    text: TextConfig = field(default_factory=TextConfig)
    embed_dim: int = 256
    temperature_init: float = 0.07


def timesformer_large_config(num_frames: int = 4, project_embed_dim: int = 256) -> LavilaConfig:
    return LavilaConfig(
        visual=SpaceTimeConfig(
            img_size=224, patch_size=14, width=1024, depth=24, heads=16, num_frames=num_frames
        ),
        text=TextConfig(width=768, heads=12, layers=12, embed_dim=project_embed_dim),
        embed_dim=project_embed_dim,
    )


def timesformer_base_config(num_frames: int = 4, project_embed_dim: int = 256) -> LavilaConfig:
    return LavilaConfig(
        visual=SpaceTimeConfig(
            img_size=224, patch_size=16, width=768, depth=12, heads=12, num_frames=num_frames
        ),
        text=TextConfig(width=512, heads=8, layers=12, embed_dim=project_embed_dim),
        embed_dim=project_embed_dim,
    )


def timesformer_tiny_config(num_frames: int = 4, project_embed_dim: int = 64) -> LavilaConfig:
    return LavilaConfig(
        visual=SpaceTimeConfig(
            img_size=224, patch_size=32, width=128, depth=2, heads=4, num_frames=num_frames
        ),
        text=TextConfig(width=64, heads=4, layers=2, embed_dim=project_embed_dim),
        embed_dim=project_embed_dim,
    )


class Lavila(nn.Module):
    """Parameters of the dual encoder (mirrors ``init_lavila_params``).

    ``text=False`` leaves out the text tower (``self.text`` is None): the
    model of a vision-only checkpoint, which embeds video only; its text
    side raises. A converted vision-only checkpoint may also lack
    ``image_projection`` or ``logit_scale`` (then None)."""

    def __init__(self, cfg: LavilaConfig, *, text: bool = True, generator=None, device=None):
        super().__init__()
        kw = {"generator": generator, "device": device}
        self.visual = SpaceTimeViT(cfg.visual, **kw)
        self.text = TextTransformer(cfg.text, **kw) if text else None
        self.image_projection = nn.Parameter(
            torch.randn(cfg.visual.width, cfg.embed_dim, device=device, generator=generator)
            * cfg.visual.width**-0.5
        )
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(1.0 / cfg.temperature_init), device=device)
        )


def encode_image(params: Lavila, cfg: LavilaConfig, video, *, dtype=torch.bfloat16, mp=None):
    """video (B, T, H, W, C) -> (projected CLS (B, E), token map (B, 1+T*N, D)).
    ``mp``: a ``parallel.ModelParallel`` whose rank holds the shard
    ``params`` (``parallel.tensor.shard_lavila``)."""
    if params.image_projection is None:
        raise ValueError("this backbone has no image_projection (a vision-only checkpoint without one)")
    x_cls, x = spacetime_forward(params.visual, cfg.visual, video, dtype=dtype, mp=mp)
    return x_cls @ params.image_projection, x


def lavila_forward(params: Lavila, cfg: LavilaConfig, video, tokens, *, norm_embed: bool = True,
                   dtype=torch.bfloat16, mp=None):
    """Image/text embeds (L2-normalised if ``norm_embed``), both feature
    maps before projection, and exp(logit_scale); ``mp`` as
    ``encode_image``."""
    image_embed, image_fmap = encode_image(params, cfg, video, dtype=dtype, mp=mp)
    text_embed, text_fmap = encode_text(params.text, cfg.text, tokens, dtype=torch.float32, mp=mp)
    if norm_embed:
        image_embed = image_embed / image_embed.norm(dim=-1, keepdim=True)
        text_embed = text_embed / text_embed.norm(dim=-1, keepdim=True)
    return {
        "image_embed": image_embed,
        "text_embed": text_embed,
        "image_feature_map": image_fmap,
        "text_feature_map": text_fmap,
        "logit_scale": params.logit_scale.exp(),
    }
