"""Seeded weights of LaViLa's narrator by checkpoint name and shape, made
on the device, and the program's model holding them.

The layout follows ``NarratorModel.state_dict()`` as the configuration file
sizes it: the TimeSformer under ``visual.*`` (the names of
``weights.backbone_layout``), ``img_queries``, the pooler's
``img_attn_pool.*`` and ``img_attn_pool_norm.*`` (coca's LayerNorms: a
``gamma`` and a zero ``beta``), and the language model under
``text_decoder.transformer.*`` in HF's ``Conv1D`` layout (weight (in,
out)). Each tensor is its own ``torch.randn`` draw, in layout order, from
one generator seeded from the run's seed, in float32, then scaled and
shifted by the first rule of the configuration's ``init`` list whose
pattern it matches (``[regex, mean, std]``; std ``"fan_in"`` is 1/sqrt of
the input features: the last axis of an (out, in) weight, the first of a
``Conv1D`` one) and cast to the type asked for. So the program gets its
bf16 weights tensor by tensor, never a whole float32 copy, and the
reference regenerates the same values in float32 from the same seed.
"""

from __future__ import annotations

import re

import torch

SALT = 0x7A11


def _ln(out, name, d, coca=False):
    if coca:
        out[f"{name}.gamma"] = (d,)
        out[f"{name}.beta"] = (d,)
    else:
        out[f"{name}.weight"] = (d,)
        out[f"{name}.bias"] = (d,)


def _conv1d(out, name, d_in, d_out):
    out[f"{name}.weight"] = (d_in, d_out)
    out[f"{name}.bias"] = (d_out,)


def is_conv1d(name: str) -> bool:
    """A weight in HF's ``Conv1D`` layout, (in, out)."""
    return name.startswith("text_decoder.") and name.endswith(".weight") and ".ln_" not in name \
        and not name.endswith(("wte.weight", "wpe.weight"))


def cross_layers(lm: dict) -> list:
    every = lm["cross_attn_every"]
    return [i for i in range(lm["n_layer"]) if every and i % every == 0]


def layout(cfg: dict) -> dict:
    """name -> shape of the narrator."""
    v, pl, lm = cfg["visual"], cfg["pool"], cfg["lm"]
    d, c = lm["n_embd"], v["width"]
    n = (v["img_size"] // v["patch_size"]) ** 2
    out: dict = {}
    out["visual.patch_embed.weight"] = (c, v["patch_size"] ** 2 * v["in_chans"])
    out["visual.cls_token"] = (1, 1, c)
    out["visual.pos_embed"] = (1, n + 1, c)
    out["visual.temporal_embed"] = (1, v["num_frames"], c)
    _ln(out, "visual.ln_pre", c)
    for i in range(v["depth"]):
        b = f"visual.blocks.{i}"
        for norm in ("norm1", "norm2", "norm3"):
            _ln(out, f"{b}.{norm}", c)
        for attn in ("attn", "timeattn"):
            out[f"{b}.{attn}.qkv.weight"], out[f"{b}.{attn}.qkv.bias"] = (3 * c, c), (3 * c,)
            out[f"{b}.{attn}.proj.weight"], out[f"{b}.{attn}.proj.bias"] = (c, c), (c,)
        hidden = c * v["mlp_ratio"]
        out[f"{b}.mlp_fc1.weight"], out[f"{b}.mlp_fc1.bias"] = (hidden, c), (hidden,)
        out[f"{b}.mlp_fc2.weight"], out[f"{b}.mlp_fc2.bias"] = (c, hidden), (c,)
    _ln(out, "visual.norm", c)
    inner = pl["heads"] * pl["dim_head"]
    out["img_queries"] = (pl["num_queries"], d)
    _ln(out, "img_attn_pool.norm", d, coca=True)
    _ln(out, "img_attn_pool.context_norm", c, coca=True)
    out["img_attn_pool.to_q.weight"] = (inner, d)
    out["img_attn_pool.to_kv.weight"] = (2 * pl["dim_head"], c)
    out["img_attn_pool.to_out.weight"] = (d, inner)
    _ln(out, "img_attn_pool_norm", d, coca=True)
    t = "text_decoder.transformer"
    out[f"{t}.wte.weight"] = (lm["vocab_size"], d)
    out[f"{t}.wpe.weight"] = (lm["n_positions"], d)
    crosses = set(cross_layers(lm))
    for i in range(lm["n_layer"]):
        b = f"{t}.h.{i}"
        _ln(out, f"{b}.ln_1", d)
        _conv1d(out, f"{b}.attn.c_attn", d, 3 * d)
        _conv1d(out, f"{b}.attn.c_proj", d, d)
        if i in crosses:
            _ln(out, f"{b}.ln_cross_attn", d)
            _conv1d(out, f"{b}.crossattention.q_attn", d, d)
            _conv1d(out, f"{b}.crossattention.c_attn", d, 2 * d)
            _conv1d(out, f"{b}.crossattention.c_proj", d, d)
            out[f"{b}.cross_attn_gate"] = (1,)
        _ln(out, f"{b}.ln_2", d)
        _conv1d(out, f"{b}.mlp.c_fc", d, lm["n_inner"])
        _conv1d(out, f"{b}.mlp.c_proj", lm["n_inner"], d)
    _ln(out, f"{t}.ln_f", d)
    return out


def _rule(rules, name):
    for pattern, mean, std in rules:
        if re.search(pattern, name):
            return mean, std
    raise ValueError(f"no init rule matches {name!r}")


def make(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The narrator's weights of ``cfg`` from ``seed``: name -> tensor of
    ``dtype`` on ``device`` (module docstring)."""
    gen = torch.Generator(device=device).manual_seed((int(seed) * 0x9E3779B1 + SALT) % (1 << 63))
    out = {}
    with torch.no_grad():
        for name, shape in layout(cfg).items():
            mean, std = _rule(cfg["init"], name)
            if std == "fan_in":
                std = (shape[0] if is_conv1d(name) else shape[-1]) ** -0.5
            t = torch.randn(shape, generator=gen, device=device)
            out[name] = t.mul_(float(std)).add_(float(mean)).to(dtype)
    return out


def port_config(cfg: dict):
    """The program's ``NarratorConfig`` for a configuration file."""
    from helping_hand_for_egocentric_videos_torch.models import SpaceTimeConfig
    from helping_hand_for_egocentric_videos_torch.models.gpt2 import GPT2Config
    from helping_hand_for_egocentric_videos_torch.models.narrator import NarratorConfig

    v, pl, lm, g = cfg["visual"], cfg["pool"], cfg["lm"], cfg["generation"]
    return NarratorConfig(
        visual=SpaceTimeConfig(img_size=v["img_size"], patch_size=v["patch_size"], in_chans=v["in_chans"],
                               width=v["width"], depth=v["depth"], heads=v["heads"], mlp_ratio=v["mlp_ratio"],
                               num_frames=v["num_frames"], ln_eps=v["ln_eps"]),
        lm=GPT2Config(**{k: lm[k] for k in ("vocab_size", "n_positions", "n_embd", "n_layer", "n_head", "n_inner",
                                            "layer_norm_epsilon", "cross_attn_every")}),
        num_img_queries=pl["num_queries"], pool_heads=pl["heads"], pool_dim_head=pl["dim_head"],
        num_return_sequences=g["num_return_sequences"], max_text_length=g["max_text_length"],
        temperature=g["temperature"], top_p=g["top_p"], bos_token_id=g["bos_token_id"],
        eos_token_id=g["eos_token_id"],
    )


def model_type(cfg: dict):
    """The type the program holds the narrator in: ``precision.visual``
    (the file states the pooler and the language model in the same one)."""
    return getattr(torch, cfg["precision"]["visual"])


def port_model(cfg: dict, seed: int, device):
    """The program's ``NarratorModel`` holding the seeded weights in
    ``model_type(cfg)`` (``load_state_dict(assign=True)``: no copy; a
    layout that differs from the program's raises)."""
    from helping_hand_for_egocentric_videos_torch.models.narrator import NarratorModel

    model = NarratorModel(port_config(cfg), device="meta")
    model.load_state_dict(make(cfg, seed, device, model_type(cfg)), strict=True, assign=True)
    return model.eval()
