"""Seeded weights of Kimi-VL-A3B's language model as a narrator, by name
and shape, each tensor from its own seed, made on the device; and the
program's model holding them.

The layout follows ``KimiNarratorModel.state_dict()`` as the configuration
file sizes it: the TimeSformer under ``visual.*``, the projector under
``multi_modal_projector.*``, the language model under
``language_model.model.*`` and ``language_model.lm_head.weight`` (each
gate and up projection one ``gate_up_proj``; a MoE layer's experts stacked,
the routed ones then the shared MLP's halves: the file's ``assumed``).
Each tensor is one ``torch.randn`` draw from a generator seeded from the
run's seed and the tensor's name, in float32, scaled and shifted by the
first rule of the configuration's ``init`` list whose pattern it matches
(``[regex, mean, std]``; std ``"fan_in"`` is 1/sqrt of the last axis), and
cast to the type asked for. So the program gets its bf16 weights tensor by
tensor, and the reference regenerates any one layer's in float32 alone
(``LayerWeights``), never the 64 GB float32 model at once.
"""

from __future__ import annotations

import hashlib
import re

import torch

LM = "language_model"


def _ln(out, name, d):
    out[f"{name}.weight"] = (d,)
    out[f"{name}.bias"] = (d,)


def visual_layout(v: dict) -> dict:
    """name -> shape of the TimeSformer (``models/spacetime_vit.py``'s names)."""
    c = v["width"]
    n = (v["img_size"] // v["patch_size"]) ** 2
    out: dict = {"visual.cls_token": (1, 1, c), "visual.pos_embed": (1, n + 1, c),
                 "visual.temporal_embed": (1, v["num_frames"], c),
                 "visual.patch_embed.weight": (c, v["patch_size"] ** 2 * v["in_chans"])}
    _ln(out, "visual.ln_pre", c)
    for i in range(v["depth"]):
        b = f"visual.blocks.{i}"
        _ln(out, f"{b}.norm1", c)
        for attn in ("attn", "timeattn"):
            out[f"{b}.{attn}.qkv.weight"], out[f"{b}.{attn}.qkv.bias"] = (3 * c, c), (3 * c,)
            out[f"{b}.{attn}.proj.weight"], out[f"{b}.{attn}.proj.bias"] = (c, c), (c,)
            if attn == "attn":
                _ln(out, f"{b}.norm3", c)
        _ln(out, f"{b}.norm2", c)
        hidden = c * v["mlp_ratio"]
        out[f"{b}.mlp_fc1.weight"], out[f"{b}.mlp_fc1.bias"] = (hidden, c), (hidden,)
        out[f"{b}.mlp_fc2.weight"], out[f"{b}.mlp_fc2.bias"] = (c, hidden), (c,)
    _ln(out, "visual.norm", c)
    return out


def layer_layout(cfg: dict, i: int) -> dict:
    """name -> shape of the language model's layer ``i``."""
    h, nh, lora = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    b = f"{LM}.model.layers.{i}"
    out = {f"{b}.input_layernorm.weight": (h,),
           f"{b}.self_attn.q_proj.weight": (nh * (nope + rope), h),
           f"{b}.self_attn.kv_a_proj_with_mqa.weight": (lora + rope, h),
           f"{b}.self_attn.kv_a_layernorm.weight": (lora,),
           f"{b}.self_attn.kv_b_proj.weight": (nh * (nope + vd), lora),
           f"{b}.self_attn.o_proj.weight": (h, nh * vd),
           f"{b}.post_attention_layernorm.weight": (h,)}
    if i < cfg["first_k_dense_replace"]:
        out[f"{b}.mlp.gate_up_proj.weight"] = (2 * cfg["intermediate_size"], h)
        out[f"{b}.mlp.down_proj.weight"] = (h, cfg["intermediate_size"])
    else:
        e, g, inter = cfg["n_routed_experts"], cfg["n_routed_experts"] + cfg["n_shared_experts"], \
            cfg["moe_intermediate_size"]
        out[f"{b}.mlp.gate.weight"] = (e, h)
        out[f"{b}.mlp.gate.e_score_correction_bias"] = (e,)
        out[f"{b}.mlp.experts.gate_up_proj"] = (g, 2 * inter, h)
        out[f"{b}.mlp.experts.down_proj"] = (g, h, inter)
    return out


def layout(cfg: dict) -> dict:
    """name -> shape of the whole narrator, in ``state_dict()`` order."""
    v, h = cfg["visual"], cfg["hidden_size"]
    wide = v["width"] * cfg["projector"]["merge"] ** 2
    out = visual_layout(v)
    p = "multi_modal_projector"
    _ln(out, f"{p}.pre_norm", v["width"])
    out[f"{p}.linear_1.weight"], out[f"{p}.linear_1.bias"] = (wide, wide), (wide,)
    out[f"{p}.linear_2.weight"], out[f"{p}.linear_2.bias"] = (h, wide), (h,)
    out[f"{LM}.model.embed_tokens.weight"] = (cfg["vocab_size"], h)
    for i in range(cfg["num_hidden_layers"]):
        out.update(layer_layout(cfg, i))
    out[f"{LM}.model.norm.weight"] = (h,)
    out[f"{LM}.lm_head.weight"] = (cfg["vocab_size"], h)
    return out


def _rule(rules, name):
    for pattern, mean, std in rules:
        if re.search(pattern, name):
            return mean, std
    raise ValueError(f"no init rule matches {name!r}")


def tensor_seed(seed: int, name: str) -> int:
    """The generator seed of one tensor: the run's seed and its name."""
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_tensor(cfg: dict, seed: int, name: str, shape, device, dtype=torch.float32):
    """One tensor of the layout from its own seed (module docstring)."""
    mean, std = _rule(cfg["init"], name)
    if std == "fan_in":
        std = shape[-1] ** -0.5
    gen = torch.Generator(device=device).manual_seed(tensor_seed(seed, name))
    with torch.no_grad():
        t = torch.randn(shape, generator=gen, device=device)
        return t.mul_(float(std)).add_(float(mean)).to(dtype)


def make(cfg: dict, seed: int, device, dtype=None) -> dict:
    """Every weight of ``cfg`` from ``seed``: name -> tensor on ``device``,
    in ``dtype``, or where None in the type the program holds it in
    (``precision.lm``)."""
    dtype = dtype or getattr(torch, cfg["precision"]["lm"])
    return {name: make_tensor(cfg, seed, name, shape, device, dtype) for name, shape in layout(cfg).items()}


class LayerWeights:
    """A mapping name -> float32 tensor that makes each tensor from its
    seed when it is read and keeps only the last group read (a layer of
    the language model, or the rest), so a layer-by-layer reference holds
    one layer's float32 weights at a time."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.shapes = layout(cfg)
        self._group, self._kept = None, {}

    @staticmethod
    def _group_of(name: str) -> str:
        """The tower, the projector, one layer of the language model, or the
        language model's embedding, final norm and head."""
        m = re.match(rf"({LM}\.model\.layers\.\d+|visual|multi_modal_projector)\.", name)
        return m.group(1) if m else LM

    def __getitem__(self, name: str):
        group = self._group_of(name)
        if group != self._group:
            self._group, self._kept = group, {}
        if name not in self._kept:
            self._kept[name] = make_tensor(self.cfg, self.seed, name, self.shapes[name], self.device)
        return self._kept[name]

    def keys(self):
        return self.shapes.keys()


def prompt_ids(cfg: dict, seed: int, device):
    """The run's ``prompt_len`` prompt ids, from the seed."""
    from . import common

    gen = torch.Generator(device=device).manual_seed(common.torch_seed(seed, 45))
    return torch.randint(0, cfg["vocab_size"], (cfg["prompt_len"],), generator=gen, device=device)


def port_config(cfg: dict):
    """The program's ``KimiNarratorConfig`` for a configuration file."""
    from helping_hand_for_egocentric_videos_torch.models import SpaceTimeConfig
    from helping_hand_for_egocentric_videos_torch.models.kimi_lm import KimiLMConfig
    from helping_hand_for_egocentric_videos_torch.models.narrator import KimiNarratorConfig

    v, g = cfg["visual"], cfg["generation"]
    lm = KimiLMConfig(**{k: cfg[k] for k in (
        "vocab_size", "hidden_size", "intermediate_size", "moe_intermediate_size", "num_hidden_layers",
        "num_attention_heads", "n_shared_experts", "n_routed_experts", "num_experts_per_tok",
        "routed_scaling_factor", "norm_topk_prob", "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
        "v_head_dim", "first_k_dense_replace", "rms_norm_eps", "rope_theta", "max_position_embeddings")},
        kv_norm_eps=cfg["kv_a_layernorm_eps"])
    return KimiNarratorConfig(
        visual=SpaceTimeConfig(img_size=v["img_size"], patch_size=v["patch_size"], in_chans=v["in_chans"],
                               width=v["width"], depth=v["depth"], heads=v["heads"], mlp_ratio=v["mlp_ratio"],
                               num_frames=v["num_frames"], ln_eps=v["ln_eps"]),
        lm=lm, merge=cfg["projector"]["merge"], projector_ln_eps=cfg["projector"]["ln_eps"],
        prompt_len=cfg["prompt_len"], num_return_sequences=g["num_return_sequences"],
        max_text_length=g["max_text_length"], temperature=g["temperature"], top_p=g["top_p"],
        bos_token_id=g["bos_token_id"], eos_token_id=g["eos_token_id"])


def port_model(cfg: dict, seed: int, device):
    """The program's ``KimiNarratorModel`` holding the seeded weights
    (``load_state_dict(assign=True)``: no copy; a layout that differs from
    the program's raises) and the run's prompt ids."""
    from helping_hand_for_egocentric_videos_torch.models.narrator import KimiNarratorModel

    model = KimiNarratorModel(port_config(cfg), device="meta")
    model.load_state_dict(make(cfg, seed, device), strict=True, assign=True)
    model.prompt_ids = prompt_ids(cfg, seed, device)
    return model.eval()
