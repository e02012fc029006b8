"""The reference's PyTorch checkpoints -> the port's modules.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/models/weights.py``:

- LaviLa dual-encoder checkpoints (``clip_openai_timesformer_{large,base}
  ...pth``, a full CLIP state dict with a ``module.`` prefix) -> ``Lavila``;
- Helping-hands decoder checkpoints (``*.pth.tar`` with a ``state_dict``
  of the ObjDecoder) -> ``ObjDecoder``;
- ``inflate_temporal_embed``: the eval-time resampling of a (1, T0, D)
  temporal embedding to T frames (run/test_egtea.py:46-96).

The port keeps torch's (out, in) Linear layout, so a weight is taken as it
is; the conv patchifier (D, C, P, P) becomes the flat channel-last
(D, P*P*C) Linear of ``spacetime_vit.patchify``; the packed
``in_proj_weight`` of an ``nn.MultiheadAttention`` splits into the port's
``wq``/``wk``/``wv``. A module is built on the ``meta`` device at the
checkpoint's own frame count and takes the converted tensors as its
parameters (``load_state_dict(assign=True)``, every key and shape
checked), so a full-size checkpoint is never initialised at random first.
The raw OpenAI CLIP bootstrap (``convert_openai_clip_checkpoint``) is not
ported yet.
"""

from __future__ import annotations

from dataclasses import replace

import torch
import torch.nn.functional as F
from torch import nn

from .lavila import Lavila, LavilaConfig
from .obj_decoder import DecoderConfig, ObjDecoder

__all__ = [
    "load_torch_state_dict",
    "convert_lavila_checkpoint",
    "convert_decoder_checkpoint",
    "inflate_temporal_embed",
]


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """``torch.load`` a checkpoint -> a state dict of f32 CPU tensors, the
    ``module.`` prefix stripped and an inner ``state_dict`` unwrapped.

    The reference's checkpoints carry pickled training arguments beside
    the weights, so they load with ``weights_only=False``: load only
    checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k.removeprefix("module."): torch.as_tensor(v).float() for k, v in sd.items()}


def _lin(sd, src: str, dst: str, out: dict):
    out[f"{dst}.weight"] = sd[f"{src}.weight"]
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = sd[f"{src}.bias"]


def _mha(sd, src: str, dst: str, out: dict):
    """torch.nn.MultiheadAttention -> the port's wq/wk/wv/wo Linears."""
    w, b = sd[f"{src}.in_proj_weight"], sd[f"{src}.in_proj_bias"]  # (3D, D), (3D,)
    for name, wi, bi in zip(("wq", "wk", "wv"), w.chunk(3), b.chunk(3)):
        out[f"{dst}.{name}.weight"], out[f"{dst}.{name}.bias"] = wi, bi
    _lin(sd, f"{src}.out_proj", f"{dst}.wo", out)


def _assign(module: nn.Module, sd: dict) -> nn.Module:
    module.load_state_dict({k: v.contiguous() for k, v in sd.items()}, strict=True, assign=True)
    return module


def convert_lavila_checkpoint(sd: dict, cfg: LavilaConfig) -> Lavila:
    """A full LaviLa CLIP state dict -> ``Lavila`` on the CPU.

    ``cfg`` gives the towers' shapes (depth, widths, vocabulary); the
    temporal embedding keeps the checkpoint's frame count (inflate it with
    ``inflate_temporal_embed``). The checkpoint must hold the text tower
    and both projections: the port's ``Lavila`` always has them."""
    conv_w = sd["visual.patch_embed.proj.weight"]  # (D, C, P, P)
    out = {"visual.patch_embed.weight": conv_w.permute(0, 2, 3, 1).reshape(conv_w.shape[0], -1)}
    for name in ("cls_token", "pos_embed", "temporal_embed"):
        out[f"visual.{name}"] = sd[f"visual.{name}"]
    for name in ("ln_pre", "norm"):
        _lin(sd, f"visual.{name}", f"visual.{name}", out)
    for i in range(cfg.visual.depth):
        src, dst = f"visual.blocks.{i}", f"visual.blocks.{i}"
        for name in ("norm1", "norm2", "norm3", "attn.qkv", "attn.proj", "timeattn.qkv", "timeattn.proj"):
            _lin(sd, f"{src}.{name}", f"{dst}.{name}", out)
        _lin(sd, f"{src}.mlp.fc1", f"{dst}.mlp_fc1", out)
        _lin(sd, f"{src}.mlp.fc2", f"{dst}.mlp_fc2", out)

    out["text.token_embedding"] = sd["token_embedding.weight"]
    for name in ("positional_embedding", "text_projection"):
        out[f"text.{name}"] = sd[name]
    _lin(sd, "ln_final", "text.ln_final", out)
    for i in range(cfg.text.layers):
        src, dst = f"transformer.resblocks.{i}", f"text.blocks.{i}"
        _lin(sd, f"{src}.ln_1", f"{dst}.ln_1", out)
        _lin(sd, f"{src}.ln_2", f"{dst}.ln_2", out)
        _mha(sd, f"{src}.attn", f"{dst}.attn", out)
        _lin(sd, f"{src}.mlp.c_fc", f"{dst}.mlp_fc", out)
        _lin(sd, f"{src}.mlp.c_proj", f"{dst}.mlp_proj", out)
    out["image_projection"] = sd["image_projection"]
    out["logit_scale"] = sd["logit_scale"].reshape(())

    t0 = sd["visual.temporal_embed"].shape[1]
    ckpt_cfg = replace(cfg, visual=replace(cfg.visual, num_frames=t0))
    return _assign(Lavila(ckpt_cfg, device="meta"), out)


def convert_decoder_checkpoint(sd: dict, cfg: DecoderConfig) -> ObjDecoder:
    """A Helping-hands ObjDecoder state dict -> ``ObjDecoder`` on the CPU.

    As in the JAX package, the trajectory head (``frame_index``,
    ``frame_proj``) is kept whenever the checkpoint has it, whatever
    ``cfg.pred_traj`` says (the forward reads ``cfg``); the temporal
    embedding keeps the checkpoint's frame count."""
    out = {}
    _lin(sd, "transformer.pre_norm", "pre_norm", out)
    _lin(sd, "transformer.decoder.norm", "decoder_norm", out)
    for i in range(cfg.num_layers):
        src, dst = f"transformer.decoder.layers.{i}", f"layers.{i}"
        for name in ("norm1", "norm2", "norm3", "linear1", "linear2"):
            _lin(sd, f"{src}.{name}", f"{dst}.{name}", out)
        _mha(sd, f"{src}.self_attn", f"{dst}.self_attn", out)
        _mha(sd, f"{src}.multihead_attn", f"{dst}.cross_attn", out)
    out["query_embed"] = sd["query_embed.weight"]
    _lin(sd, "class_embed", "class_embed", out)
    for i in range(3):
        _lin(sd, f"bbox_embed.layers.{i}", f"bbox_mlp.{i}", out)
    _lin(sd, "proj", "proj", out)
    out["pos_embed"], out["temporal_embed"] = sd["pos_embed"], sd["temporal_embed"]
    _lin(sd, "txt_proj.1", "txt_proj", out)
    _lin(sd, "vid_proj.0", "vid_proj", out)
    _lin(sd, "obj_proj.0", "obj_proj.0", out)
    _lin(sd, "obj_proj.2", "obj_proj.1", out)
    traj = "frame_index.weight" in sd
    if traj:
        out["frame_index"] = sd["frame_index.weight"]
        _lin(sd, "frame_proj", "frame_proj", out)
    if "query_index.weight" in sd:
        out["query_index"] = sd["query_index.weight"]

    ckpt_cfg = replace(cfg, num_frames=sd["temporal_embed"].shape[1], pred_traj=traj)
    return _assign(ObjDecoder(ckpt_cfg, device="meta"), out)


def inflate_temporal_embed(temporal_embed: torch.Tensor, num_frames: int) -> torch.Tensor:
    """Resample a (1, T0, D) temporal embedding to (1, num_frames, D).

    Longer than needed: the first frames (run/test_egtea.py:66-68).
    Shorter: a linear resize with ``align_corners=False`` and no
    antialias, the reference's bilinear ``F.interpolate`` on a
    (1, 1, T, D) image (run/test_egtea.py:74-88)."""
    t0 = temporal_embed.shape[1]
    if t0 == num_frames:
        return temporal_embed
    if t0 > num_frames:
        return temporal_embed[:, :num_frames].contiguous()
    resized = F.interpolate(temporal_embed.transpose(1, 2), size=num_frames, mode="linear",
                            align_corners=False)
    return resized.transpose(1, 2).contiguous()
