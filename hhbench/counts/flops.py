"""Analytic model FLOPs (2 FLOPs a multiply-add) on a configuration file's
dicts.

A copy of the counters of
``helping_hand_for_egocentric_videos_torch/utils/flops.py``, taking the
``visual``, ``text`` and ``decoder`` groups of ``hhbench/configs/*.json``
in place of the port's dataclasses; a CPU test holds the two equal at
every cell's shapes. Layernorms, softmax and activations are not counted.
"""

from __future__ import annotations


def patches_per_frame(visual: dict) -> int:
    return (visual["img_size"] // visual["patch_size"]) ** 2


def vision_fwd_flops(visual: dict, frames: int | None = None) -> float:
    """The TimeSformer forward of one clip: both attention passes' qkv and
    output projections, spatial scores within each frame, temporal scores
    along each patch tube, the MLP and the patchifier."""
    d, depth, t = visual["width"], visual["depth"], int(frames or visual["num_frames"])
    n = patches_per_frame(visual)
    s = 1 + n * t
    per_block = (
        8 * s * d * d
        + 8 * s * d * d
        + 4 * t * n * n * d
        + 4 * n * t * t * d
        + 4 * visual["mlp_ratio"] * s * d * d
    )
    patchify = n * t * d * (visual["patch_size"] ** 2 * visual["in_chans"]) * 2
    return float(depth * per_block + patchify)


def text_fwd_flops(text: dict) -> float:
    """The CLIP text tower's forward of one caption."""
    d, s = text["width"], text["context_length"]
    return float(text["layers"] * (24 * s * d * d + 4 * s * s * d))


def decoder_fwd_flops(decoder: dict) -> float:
    """The object decoder's forward of one clip: the input projection and
    the cross-attention's key and value projections over the T*N memory
    tokens dominate; the query side and the class and box heads count too."""
    d, q = decoder["d_model"], decoder["num_queries"]
    mem = decoder["num_frames"] * decoder["patches_per_frame"]
    input_proj = 2 * mem * decoder["feature_dim"] * d
    per_layer = (
        8 * q * d * d
        + 4 * q * q * d
        + 4 * q * d * d
        + 4 * mem * d * d
        + 4 * q * mem * d
        + 4 * decoder["dim_feedforward"] * q * d
    )
    heads = 2 * q * d * (decoder["num_classes"] + 4)
    return float(input_proj + decoder["num_layers"] * per_layer + heads)


def embed_flops_per_clip(cfg: dict) -> float:
    """What ``EvalModel.embed_clips`` computes for one clip: the visual
    tower and the decoder (no caption: the embedding path runs no text)."""
    return vision_fwd_flops(cfg["visual"]) + decoder_fwd_flops(cfg["decoder"])


def train_step_flops_per_clip(cfg: dict, rephrase_factor: int = 5) -> float:
    """One training clip: the frozen backbone's forward (no backward), the
    text tower once a caption, and the decoder forward and backward (3x
    its forward)."""
    return (
        vision_fwd_flops(cfg["visual"])
        + rephrase_factor * text_fwd_flops(cfg["text"])
        + 3.0 * decoder_fwd_flops(cfg["decoder"])
    )
