"""LaViLa's narrator: model FLOPs of a narrated clip, and the least time of
a decode step's attention, from the configuration file's shapes alone.

The FLOPs are a copy of ``helping_hand_for_egocentric_videos_torch/utils/
flops.py``'s ``narrator_*`` counters on the file's dicts (2 FLOPs a
multiply-add; LayerNorms, softmax, activations and sampling not counted):
the tower (``flops.vision_fwd_flops``), the pooler, the cross keys and
values once a clip, and R sequences decoded for ``max_text_length - 1``
steps, step ``p`` attending ``p + 1`` positions. A CPU test holds them
equal to the program's.

The decode attention's bytes, whatever implements it: at step ``p`` every
block's self-attention reads the keys and values of ``p + 1`` positions of
every sequence and every cross block reads each clip's keys and values of
the latents once (the R sequences of a clip share them), and each
attention call reads its queries and writes its output, one row of
``n_embd`` a sequence; elements of the model's type. Its operations: 4 *
keys * n_embd a row. The least time is the larger of bytes over the
card's bandwidth and operations over its peak in that type.
"""

from __future__ import annotations

from .attention import ELEMENT_BYTES
from .flops import vision_fwd_flops


def _cross_layers(lm: dict) -> int:
    every = lm["cross_attn_every"]
    return sum(1 for i in range(lm["n_layer"]) if every and i % every == 0)


def pool_flops(cfg: dict) -> float:
    v, pl, d = cfg["visual"], cfg["pool"], cfg["lm"]["n_embd"]
    m, c, dh = pl["num_queries"], v["width"], pl["dim_head"]
    s = 1 + (v["img_size"] // v["patch_size"]) ** 2 * v["num_frames"]
    inner = pl["heads"] * dh
    return float(2 * m * d * inner + 2 * s * c * 2 * dh + 4 * pl["heads"] * m * s * dh + 2 * m * inner * d)


def cross_kv_flops(cfg: dict) -> float:
    d = cfg["lm"]["n_embd"]
    return float(_cross_layers(cfg["lm"]) * 2 * cfg["pool"]["num_queries"] * d * 2 * d)


def token_flops(lm: dict, keys: int, latents: int) -> float:
    d = lm["n_embd"]
    per_block = 2 * d * 3 * d + 2 * d * d + 4 * d * lm["n_inner"] + 4 * keys * d
    per_cross = 4 * d * d + 4 * latents * d
    return float(lm["n_layer"] * per_block + _cross_layers(lm) * per_cross + 2 * d * lm["vocab_size"])


def flops_per_clip(cfg: dict) -> float:
    g, m = cfg["generation"], cfg["pool"]["num_queries"]
    decode = sum(token_flops(cfg["lm"], p + 1, m) for p in range(g["max_text_length"] - 1))
    return vision_fwd_flops(cfg["visual"]) + pool_flops(cfg) + cross_kv_flops(cfg) + g["num_return_sequences"] * decode


def decode_attn_work(cfg: dict, clips: int, dtype: str) -> tuple:
    """(bytes, operations) of every decode step's attention calls for
    ``clips`` narrated clips."""
    lm, g, m = cfg["lm"], cfg["generation"], cfg["pool"]["num_queries"]
    e, d, r = ELEMENT_BYTES[dtype], lm["n_embd"], g["num_return_sequences"]
    n, crosses = clips * r, _cross_layers(lm)
    nbytes = ops = 0
    for p in range(g["max_text_length"] - 1):
        keys = p + 1
        nbytes += lm["n_layer"] * (n * 2 * keys * d + 2 * n * d) + crosses * (clips * 2 * m * d + 2 * n * d)
        ops += lm["n_layer"] * n * 4 * keys * d + crosses * n * 4 * m * d
    return float(e * nbytes), float(ops)


def decode_attn_least_seconds(cfg: dict, clips: int, dtype: str, peaks: dict) -> float:
    nbytes, ops = decode_attn_work(cfg, clips, dtype)
    return max(nbytes / peaks["bytes"], ops / peaks[dtype])
