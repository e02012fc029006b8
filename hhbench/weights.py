"""Seeded weights by checkpoint name and shape, made on the device.

The layout (names and shapes) follows the published checkpoints' modules
as the configuration file sizes them: LaViLa's ``visual.*`` and ``text.*``
and the Helping Hands decoder's names. The values come from one
``torch.randn`` call a model on a generator seeded from the run's seed, in
float32, the type in which the program takes them (it makes its own bf16
copy of the visual tower); each tensor is then scaled and shifted by the
first rule of the configuration's ``init`` list whose pattern it matches:
``[regex, mean, std]``, where std ``"fan_in"`` is 1/sqrt(in features).
The same seed gives the same tensors, so the reference regenerates them
after the program has run instead of reading the program's copies.
"""

from __future__ import annotations

import re

import torch

SEED_SALT = {"backbone": 0x51A7, "decoder": 0xDEC0}


def _ln(out, name, d):
    out[f"{name}.weight"] = (d,)
    out[f"{name}.bias"] = (d,)


def _linear(out, name, d_in, d_out, bias=True):
    out[f"{name}.weight"] = (d_out, d_in)
    if bias:
        out[f"{name}.bias"] = (d_out,)


def backbone_layout(cfg: dict) -> dict:
    """name -> shape of the LaViLa backbone (TimeSformer + CLIP text)."""
    v, t = cfg["visual"], cfg["text"]
    d, e = v["width"], cfg["embed_dim"]
    n = (v["img_size"] // v["patch_size"]) ** 2
    out: dict = {}
    out["visual.patch_embed.weight"] = (d, v["patch_size"] ** 2 * v["in_chans"])
    out["visual.cls_token"] = (1, 1, d)
    out["visual.pos_embed"] = (1, n + 1, d)
    out["visual.temporal_embed"] = (1, v["num_frames"], d)
    _ln(out, "visual.ln_pre", d)
    for i in range(v["depth"]):
        b = f"visual.blocks.{i}"
        for norm in ("norm1", "norm2", "norm3"):
            _ln(out, f"{b}.{norm}", d)
        for attn in ("attn", "timeattn"):
            _linear(out, f"{b}.{attn}.qkv", d, 3 * d)
            _linear(out, f"{b}.{attn}.proj", d, d)
        _linear(out, f"{b}.mlp_fc1", d, d * v["mlp_ratio"])
        _linear(out, f"{b}.mlp_fc2", d * v["mlp_ratio"], d)
    _ln(out, "visual.norm", d)
    w = t["width"]
    out["text.token_embedding"] = (t["vocab_size"], w)
    out["text.positional_embedding"] = (t["context_length"], w)
    for i in range(t["layers"]):
        b = f"text.blocks.{i}"
        _ln(out, f"{b}.ln_1", w)
        for m in ("wq", "wk", "wv", "wo"):
            _linear(out, f"{b}.attn.{m}", w, w)
        _ln(out, f"{b}.ln_2", w)
        _linear(out, f"{b}.mlp_fc", w, 4 * w)
        _linear(out, f"{b}.mlp_proj", 4 * w, w)
    _ln(out, "text.ln_final", w)
    out["text.text_projection"] = (w, e)
    out["image_projection"] = (d, e)
    out["logit_scale"] = ()
    return out


def decoder_layout(cfg: dict) -> dict:
    """name -> shape of the object decoder."""
    c = cfg["decoder"]
    d, f = c["d_model"], c["dim_feedforward"]
    out: dict = {}
    _ln(out, "pre_norm", d)
    for i in range(c["num_layers"]):
        b = f"layers.{i}"
        for norm in ("norm1", "norm2", "norm3"):
            _ln(out, f"{b}.{norm}", d)
        for attn in ("self_attn", "cross_attn"):
            for m in ("wq", "wk", "wv", "wo"):
                _linear(out, f"{b}.{attn}.{m}", d, d)
        _linear(out, f"{b}.linear1", d, f)
        _linear(out, f"{b}.linear2", f, d)
    _ln(out, "decoder_norm", d)
    out["query_embed"] = (c["num_queries"], d)
    _linear(out, "class_embed", d, c["num_classes"] + 1)
    _linear(out, "bbox_mlp.0", d, d)
    _linear(out, "bbox_mlp.1", d, d)
    _linear(out, "bbox_mlp.2", d, 4)
    _linear(out, "proj", c["feature_dim"], d, bias=False)
    out["pos_embed"] = (1, c["patches_per_frame"] + 1, d)
    out["temporal_embed"] = (1, c["num_frames"], d)
    _linear(out, "txt_proj", c["text_width"], c["embed_dim"])
    _linear(out, "vid_proj", c["text_width"], c["embed_dim"])
    _linear(out, "obj_proj.0", d, d)
    _linear(out, "obj_proj.1", d, c["embed_dim"])
    if c["pred_traj"]:
        out["frame_index"] = (c["num_frames"], d)
        _linear(out, "frame_proj", 2 * d, d)
    if c["num_queries"] == 1:
        out["query_index"] = (c["n_decode"], d)
    return out


def _rule(rules, name):
    for pattern, mean, std in rules:
        if re.search(pattern, name):
            return mean, std
    raise ValueError(f"no init rule matches {name!r}")


def make(cfg: dict, part: str, seed: int, device) -> dict:
    """The ``part`` ("backbone" or "decoder") weights of ``cfg`` from
    ``seed``: name -> float32 tensor on ``device`` (views of one buffer)."""
    layout = backbone_layout(cfg) if part == "backbone" else decoder_layout(cfg)
    sizes = {k: int(torch.Size(s).numel()) for k, s in layout.items()}
    gen = torch.Generator(device=device).manual_seed((int(seed) * 0x9E3779B1 + SEED_SALT[part]) % (1 << 63))
    flat = torch.randn(sum(sizes.values()), generator=gen, device=device)
    out, off = {}, 0
    with torch.no_grad():
        for name, shape in layout.items():
            n = sizes[name]
            t = flat[off:off + n].view(shape)
            off += n
            mean, std = _rule(cfg["init"], name)
            if std == "fan_in":
                std = shape[-1] ** -0.5
            t.mul_(float(std)).add_(float(mean))
            out[name] = t
    return out


def port_models(cfg: dict, backbone_w: dict | None, decoder_w: dict, device):
    """The program's ``Lavila`` (None without ``backbone_w``) and
    ``ObjDecoder`` holding these tensors (``load_state_dict(assign=True)``:
    no copy; a layout that differs from the program's raises)."""
    from helping_hand_for_egocentric_videos_torch.models import Lavila, ObjDecoder

    lcfg, dcfg = port_configs(cfg)
    backbone = None
    if backbone_w is not None:
        backbone = Lavila(lcfg, device="meta")
        backbone.load_state_dict(backbone_w, strict=True, assign=True)
    decoder = ObjDecoder(dcfg, device="meta")
    decoder.load_state_dict(decoder_w, strict=True, assign=True)
    return backbone, decoder


def port_configs(cfg: dict):
    """The program's (LavilaConfig, DecoderConfig) for a configuration."""
    from helping_hand_for_egocentric_videos_torch.models import DecoderConfig, LavilaConfig, SpaceTimeConfig, TextConfig

    v, t, d = cfg["visual"], cfg["text"], cfg["decoder"]
    lcfg = LavilaConfig(
        visual=SpaceTimeConfig(img_size=v["img_size"], patch_size=v["patch_size"], in_chans=v["in_chans"],
                               width=v["width"], depth=v["depth"], heads=v["heads"], mlp_ratio=v["mlp_ratio"],
                               num_frames=v["num_frames"], ln_eps=v["ln_eps"]),
        text=TextConfig(vocab_size=t["vocab_size"], context_length=t["context_length"], width=t["width"],
                        heads=t["heads"], layers=t["layers"], embed_dim=cfg["embed_dim"]),
        embed_dim=cfg["embed_dim"],
    )
    dcfg = DecoderConfig(**{k: d[k] for k in ("d_model", "nhead", "num_layers", "dim_feedforward", "dropout",
                                              "num_queries", "num_classes", "feature_dim", "text_width",
                                              "embed_dim", "num_frames", "patches_per_frame", "pred_traj")})
    return lcfg, dcfg
