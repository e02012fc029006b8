"""Kimi-VL-A3B's language model as a narrator: model FLOPs of a narrated
clip, and the least times of its experts, its latent attention and its
sampler, from the configuration file's shapes alone.

The FLOPs are a copy of ``helping_hand_for_egocentric_videos_torch/utils/
flops.py::kimivl_flops_per_clip`` on the file's dict (2 FLOPs a
multiply-add; norms, softmax, activations, RoPE, the router's sort and the
sampling not counted), as the program computes the clip: the tower
(``flops.vision_fwd_flops``), the projector, the prefill of the clip's P
positions (every layer's projections, causal attention position i over i +
1 keys, the MLP or the router and the 6 + 2 experts' SwiGLU a token; the
last layer only its latents), and R sequences decoded for
``max_text_length - 1`` steps, step ``p`` absorbed over P + p + 1 keys,
with ``lm_head``. A CPU test holds them equal to the program's.

The least times (``peaks``: ``counts.peaks.PEAKS[...]``; elements of the
model's type):

- ``expert_least_seconds``: every expert call of the traced batch, each the
  larger of its bytes (the weights of the groups it hits, and its rows in
  and out of both grouped GEMMs) over the bandwidth and its operations over
  the peak. The prefill's calls hit every group (its B x P x 6 rows over 64
  experts); the decode steps' rows and hits are the program's counters
  ``hh.narrate.expert_rows`` (less the prefill's) and
  ``hh.narrate.experts_hit``, plus the shared groups.
- ``latent_attn_least_seconds``: at every decode step, every layer reads
  each clip's prefix of latents once and each sequence's tail, reads its
  query rows and writes its outputs; 2 x (576 + 512) operations a (row,
  key).
- ``sample_least_seconds``: every step reads N rows of V f32 logits and
  writes an int64 id a row.
"""

from __future__ import annotations

from .attention import ELEMENT_BYTES
from .flops import vision_fwd_flops


def _dims(cfg: dict) -> dict:
    v, pr = cfg["visual"], cfg["projector"]
    visual = v["num_frames"] * ((v["img_size"] // v["patch_size"]) // pr["merge"]) ** 2
    return {"h": cfg["hidden_size"], "nh": cfg["num_attention_heads"], "nope": cfg["qk_nope_head_dim"],
            "rope": cfg["qk_rope_head_dim"], "vd": cfg["v_head_dim"], "lora": cfg["kv_lora_rank"],
            "groups": cfg["n_routed_experts"] + cfg["n_shared_experts"], "k": cfg["num_experts_per_tok"],
            "inter": cfg["moe_intermediate_size"], "prefix": visual + cfg["prompt_len"],
            "moe": cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]}


def projector_flops(cfg: dict) -> float:
    v, pr, h = cfg["visual"], cfg["projector"], cfg["hidden_size"]
    wide = v["width"] * pr["merge"] ** 2
    tokens = v["num_frames"] * ((v["img_size"] // v["patch_size"]) // pr["merge"]) ** 2
    return float(tokens * (2 * wide * wide + 2 * wide * h))


def _mlp_token_flops(cfg: dict, i: int) -> float:
    d = _dims(cfg)
    if i < cfg["first_k_dense_replace"]:
        return 6.0 * d["h"] * cfg["intermediate_size"]
    return 2.0 * d["h"] * cfg["n_routed_experts"] + (d["k"] + cfg["n_shared_experts"]) * 6.0 * d["h"] * d["inter"]


def _proj_token_flops(cfg: dict) -> float:
    """q_proj, kv_a_proj_with_mqa and o_proj of one token."""
    d = _dims(cfg)
    return 2.0 * d["h"] * (d["nh"] * (d["nope"] + d["rope"]) + d["lora"] + d["rope"] + d["nh"] * d["vd"])


def prefill_flops(cfg: dict) -> float:
    """One clip's prefix through the layers (the last: its latents alone)."""
    d = _dims(cfg)
    p = d["prefix"]
    kv_b = 2.0 * d["lora"] * d["nh"] * (d["nope"] + d["vd"])
    attn = 2.0 * d["nh"] * (d["nope"] + d["rope"] + d["vd"]) * p * (p + 1) / 2
    total = 0.0
    for i in range(cfg["num_hidden_layers"] - 1):
        total += p * (_proj_token_flops(cfg) + kv_b + _mlp_token_flops(cfg, i)) + attn
    return total + p * 2.0 * d["h"] * (d["lora"] + d["rope"])


def decode_token_flops(cfg: dict, keys: int) -> float:
    """One sequence's token at a decode step over ``keys`` positions."""
    d = _dims(cfg)
    absorb = 2.0 * d["nh"] * d["nope"] * d["lora"] + 2.0 * d["nh"] * d["lora"] * d["vd"]
    attn = 2.0 * d["nh"] * keys * (d["lora"] + d["rope"] + d["lora"])
    layers = sum(_proj_token_flops(cfg) + absorb + attn + _mlp_token_flops(cfg, i)
                 for i in range(cfg["num_hidden_layers"]))
    return layers + 2.0 * d["h"] * cfg["vocab_size"]


def flops_per_clip(cfg: dict) -> float:
    g, d = cfg["generation"], _dims(cfg)
    decode = sum(decode_token_flops(cfg, d["prefix"] + p + 1) for p in range(g["max_text_length"] - 1))
    return (vision_fwd_flops(cfg["visual"]) + projector_flops(cfg) + prefill_flops(cfg)
            + g["num_return_sequences"] * decode)


def _expert_call(cfg: dict, rows: int, hit: float, e: int) -> tuple:
    """(bytes, operations) of one MoE layer's two grouped GEMMs: ``rows``
    token-group rows over ``hit`` groups."""
    d = _dims(cfg)
    weights = hit * 3 * d["h"] * d["inter"]
    moved = rows * (d["h"] + 2 * d["inter"] + d["inter"] + d["h"])
    return float(e * (weights + moved)), float(rows * 6 * d["h"] * d["inter"])


def expert_least_seconds(cfg: dict, clips: int, steps: int, experts_hit: int, expert_rows: int, dtype: str,
                         peaks: dict) -> float:
    """The least time of a traced batch's expert GEMMs (module docstring):
    ``clips`` clips, ``steps`` decode steps; the program's counters
    ``experts_hit`` (routed experts hit over the decode steps' MoE layers)
    and ``expert_rows`` (routed token-expert rows, prefill and decode)."""
    d, e = _dims(cfg), ELEMENT_BYTES[dtype]
    shared, k = cfg["n_shared_experts"], d["k"]
    prefill_rows = clips * d["prefix"] * k * (d["moe"] - 1)
    nb, ops = _expert_call(cfg, clips * d["prefix"] * (k + shared), d["groups"], e)
    least = (d["moe"] - 1) * max(nb / peaks["bytes"], ops / peaks[dtype])
    calls = steps * d["moe"]
    if calls:
        rows = (expert_rows - prefill_rows) / calls * (k + shared) / k
        nb, ops = _expert_call(cfg, rows, experts_hit / calls + shared, e)
        least += calls * max(nb / peaks["bytes"], ops / peaks[dtype])
    return least


def latent_attn_work(cfg: dict, clips: int, dtype: str) -> tuple:
    """(bytes, operations) of every decode step's latent attention for
    ``clips`` narrated clips."""
    d, e, g = _dims(cfg), ELEMENT_BYTES[dtype], cfg["generation"]
    n, width = clips * g["num_return_sequences"], d["lora"] + d["rope"]
    nbytes = ops = 0
    for p in range(g["max_text_length"] - 1):
        keys = d["prefix"] + p + 1
        nbytes += clips * d["prefix"] * width + n * (p + 1) * width + n * d["nh"] * (width + d["lora"])
        ops += n * d["nh"] * keys * 2 * (width + d["lora"])
    layers = cfg["num_hidden_layers"]
    return float(layers * e * nbytes), float(layers * ops)


def latent_attn_least_seconds(cfg: dict, clips: int, dtype: str, peaks: dict) -> float:
    nbytes, ops = latent_attn_work(cfg, clips, dtype)
    return max(nbytes / peaks["bytes"], ops / peaks[dtype])


def sample_least_seconds(cfg: dict, clips: int, peaks: dict) -> float:
    g = cfg["generation"]
    rows = clips * g["num_return_sequences"]
    return (g["max_text_length"] - 1) * (rows * cfg["vocab_size"] * 4 + rows * 8) / peaks["bytes"]
