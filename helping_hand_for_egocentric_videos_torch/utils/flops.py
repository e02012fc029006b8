"""Analytic model-FLOPs counters (2 FLOPs per MAC) for roofline/mfu math.

A copy of the counters of
``helping_hand_for_egocentric_videos_tpu/utils/flops.py`` (the port imports
nothing of the JAX package). The reference publishes no
FLOPs or throughput numbers, so an mfu figure needs a model-fixed
numerator. These counters are pure dimension arithmetic on the config
dataclasses (~3.43e12 for the TimeSformer-L 16-frame eval forward).

Counting rules:
- matmul (m, k) @ (k, n): 2*m*k*n FLOPs;
- divided space-time attention (model/LaviLa.py:226-303): separate
  qkv+proj for the temporal and the spatial pass, spatial scores within
  each frame over n patches, temporal scores across T frames per patch;
- layernorms, softmax, activations: not counted (sub-1% at these dims).
"""

from __future__ import annotations


def vision_fwd_flops(cfg, frames: int | None = None) -> float:
    """SpaceTimeTransformer forward FLOPs for one clip.

    cfg: models.spacetime_vit.SpaceTimeConfig; frames overrides
    cfg.num_frames (the eval harnesses inflate 4 -> 16).
    """
    d, depth, t = cfg.width, cfg.depth, int(frames or cfg.num_frames)
    n = (cfg.img_size // cfg.patch_size) ** 2
    s = 1 + n * t
    per_block = (
        8 * s * d * d          # spatial attn qkv + out proj
        + 8 * s * d * d        # temporal attn qkv + out proj
        + 4 * t * n * n * d    # spatial scores + values, per frame
        + 4 * n * t * t * d    # temporal scores + values, per patch
        + 4 * cfg.mlp_ratio * s * d * d  # MLP in+out
    )
    patchify = n * t * d * (cfg.patch_size**2 * cfg.in_chans) * 2
    return float(depth * per_block + patchify)


def text_fwd_flops(cfg) -> float:
    """CLIP text tower forward FLOPs for one caption (clip_text.py)."""
    d, s = cfg.width, cfg.context_length
    return float(cfg.layers * (24 * s * d * d + 4 * s * s * d))


def decoder_fwd_flops(cfg) -> float:
    """ObjDecoder forward FLOPs for one clip (obj_decoder.py).

    Dominated by the memory-side projections: input proj feature_dim ->
    d_model over T*N grid tokens and the per-layer cross-attention k/v
    projections over the same memory.  Query-side work (num_queries
    tokens) is counted but negligible.
    """
    d, q = cfg.d_model, cfg.num_queries
    mem = cfg.num_frames * cfg.patches_per_frame
    input_proj = 2 * mem * cfg.feature_dim * d
    per_layer = (
        8 * q * d * d              # self-attn qkv+proj on queries
        + 4 * q * q * d            # self-attn scores+values
        + 4 * q * d * d            # cross-attn q proj + out proj
        + 4 * mem * d * d          # cross-attn k+v proj on memory
        + 4 * q * mem * d          # cross scores + values
        + 4 * cfg.dim_feedforward * q * d  # FFN
    )
    heads = 2 * q * d * (cfg.num_classes + 4)  # class + box heads
    return float(input_proj + cfg.num_layers * per_layer + heads)


def eval_fwd_flops_per_clip(lavila_cfg, dec_cfg, frames: int | None = None) -> float:
    """Epic/EgoMCQ eval per-item work: backbone fwd (one clip + one
    caption) + decoder fwd (run/test_epic.py:208-226)."""
    return (
        vision_fwd_flops(lavila_cfg.visual, frames)
        + text_fwd_flops(lavila_cfg.text)
        + decoder_fwd_flops(dec_cfg)
    )


def train_step_flops_per_clip(lavila_cfg, dec_cfg, rephrase_factor: int = 5) -> float:
    """Pretrain step FLOPs per video clip: the frozen backbone forward
    only (it runs under ``no_grad``, so it has no backward), the text tower
    once per caption (``rephrase_factor`` a clip), and the trained decoder
    and projections forward and backward, about 3x its forward."""
    return (
        vision_fwd_flops(lavila_cfg.visual)
        + rephrase_factor * text_fwd_flops(lavila_cfg.text)
        + 3.0 * decoder_fwd_flops(dec_cfg)
    )
