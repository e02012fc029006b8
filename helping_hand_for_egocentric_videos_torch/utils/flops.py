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

``PEAKS`` holds the card's dense peaks, the denominators of every mfu and
roofline bound the port's scripts print; ``peaks_for`` picks its column
from the device's name.
"""

from __future__ import annotations

# Dense peaks of one NVIDIA H100 from NVIDIA's data sheets (no sparsity, at
# the full power limit): memory bytes/s and operations/s by type.
PEAKS = {
    "sxm": {"bytes": 3.35e12, "bfloat16": 989e12, "float32": 67e12, "int8": 1979e12},
    "pcie": {"bytes": 2.0e12, "bfloat16": 756e12, "float32": 51e12, "int8": 1513e12},
}


def peaks_for(device_name: str) -> dict:
    """The column of ``PEAKS`` for a card's name
    (``torch.cuda.get_device_name``): the PCIe part where the name says
    PCIe, else the SXM part."""
    return PEAKS["pcie" if "pcie" in device_name.lower() else "sxm"]


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


def narrator_pool_flops(cfg) -> float:
    """LaViLa's attention pooler for one clip (models/narrator.py): the
    queries' projection, the shared key/value projection of every tower
    token, the 25 heads' scores and values over them, the output projection."""
    d, c, m = cfg.lm.n_embd, cfg.visual.width, cfg.num_img_queries
    s = 1 + cfg.visual.patches_per_frame * cfg.visual.num_frames
    inner, dh = cfg.pool_heads * cfg.pool_dim_head, cfg.pool_dim_head
    return float(2 * m * d * inner + 2 * s * c * 2 * dh + 4 * cfg.pool_heads * m * s * dh + 2 * m * inner * d)


def narrator_cross_kv_flops(cfg) -> float:
    """Every cross layer's keys and values of one clip's latents, made once."""
    d = cfg.lm.n_embd
    return float(len(cfg.lm.cross_layers) * 2 * cfg.num_img_queries * d * 2 * d)


def gpt2_token_flops(lm, keys: int, latents: int) -> float:
    """One token through the gated GPT-2 (models/gpt2.py): every block's
    projections and MLP, its self-attention over ``keys`` positions, each
    cross block's query and output projections and its attention over
    ``latents`` keys, and ``lm_head``."""
    d = lm.n_embd
    per_block = 2 * d * 3 * d + 2 * d * d + 4 * d * lm.n_inner + 4 * keys * d
    per_cross = 4 * d * d + 4 * latents * d
    return float(lm.n_layer * per_block + len(lm.cross_layers) * per_cross + 2 * d * lm.vocab_size)


def narrator_flops_per_clip(cfg) -> float:
    """One narrated clip (``NarratorModel.narrate``): the tower, the pooler,
    the cross keys and values, and R sequences decoded for
    ``max_text_length - 1`` steps, step ``p`` attending ``p + 1`` positions."""
    m = cfg.num_img_queries
    decode = sum(gpt2_token_flops(cfg.lm, p + 1, m) for p in range(cfg.max_text_length - 1))
    return (vision_fwd_flops(cfg.visual) + narrator_pool_flops(cfg) + narrator_cross_kv_flops(cfg)
            + cfg.num_return_sequences * decode)


def _kimi_mlp_token_flops(lm, i: int) -> float:
    """Layer ``i``'s MLP of one token (models/kimi_lm.py): the dense SwiGLU,
    or the router and the 6 routed and 2 shared experts' SwiGLU."""
    if i < lm.first_k_dense_replace:
        return 6.0 * lm.hidden_size * lm.intermediate_size
    return (2.0 * lm.hidden_size * lm.n_routed_experts
            + (lm.num_experts_per_tok + lm.n_shared_experts) * 6.0 * lm.hidden_size * lm.moe_intermediate_size)


def _kimi_proj_token_flops(lm) -> float:
    """q_proj, kv_a_proj_with_mqa and o_proj of one token."""
    return 2.0 * lm.hidden_size * (lm.num_attention_heads * lm.q_head_dim + lm.latent_dim
                                   + lm.num_attention_heads * lm.v_head_dim)


def kimivl_prefill_flops(cfg) -> float:
    """One clip's prefix of ``cfg.prefix_len`` positions through Kimi-VL's
    language model (``kimi_lm.prefill``): explicit MLA, causal (position i
    over i + 1 keys), every layer but the last, which makes its latents
    alone."""
    lm, p = cfg.lm, cfg.prefix_len
    kv_b = 2.0 * lm.kv_lora_rank * lm.num_attention_heads * (lm.qk_nope_head_dim + lm.v_head_dim)
    attn = 2.0 * lm.num_attention_heads * (lm.q_head_dim + lm.v_head_dim) * p * (p + 1) / 2
    total = sum(p * (_kimi_proj_token_flops(lm) + kv_b + _kimi_mlp_token_flops(lm, i)) + attn
                for i in range(lm.num_hidden_layers - 1))
    return total + p * 2.0 * lm.hidden_size * lm.latent_dim


def kimivl_decode_token_flops(lm, keys: int) -> float:
    """One sequence's token at a decode step (``kimi_lm.decode_step``):
    absorbed MLA over ``keys`` positions (q_nope . W_uk, scores over the 576
    latent columns, the weighted sum of the 512-wide latents, W_uv), the
    MLP or the experts, and ``lm_head``."""
    absorb = 4.0 * lm.num_attention_heads * lm.kv_lora_rank * lm.qk_nope_head_dim
    attn = 2.0 * lm.num_attention_heads * keys * (lm.latent_dim + lm.kv_lora_rank)
    layers = sum(_kimi_proj_token_flops(lm) + absorb + attn + _kimi_mlp_token_flops(lm, i)
                 for i in range(lm.num_hidden_layers))
    return layers + 2.0 * lm.hidden_size * lm.vocab_size


def kimivl_flops_per_clip(cfg) -> float:
    """One clip narrated by Kimi-VL's language model
    (``KimiNarratorModel.narrate``): the tower, the projector (LayerNorm,
    2 x 2 merge, two linears over its visual tokens), the prefix's prefill,
    and R sequences decoded for ``max_text_length - 1`` steps, step ``p``
    over ``prefix_len + p + 1`` keys."""
    wide = cfg.visual.width * cfg.merge**2
    projector = cfg.visual_tokens * (2.0 * wide * wide + 2.0 * wide * cfg.lm.hidden_size)
    decode = sum(kimivl_decode_token_flops(cfg.lm, cfg.prefix_len + p + 1) for p in range(cfg.max_text_length - 1))
    return (vision_fwd_flops(cfg.visual) + projector + kimivl_prefill_flops(cfg)
            + cfg.num_return_sequences * decode)
