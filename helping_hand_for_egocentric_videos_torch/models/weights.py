"""The reference's PyTorch checkpoints -> the port's modules.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/models/weights.py``:

- LaviLa dual-encoder checkpoints (``clip_openai_timesformer_{large,base}
  ...pth``, a full CLIP state dict with a ``module.`` prefix) -> ``Lavila``,
  and vision-only ones (no text tower) -> a ``Lavila`` without one;
- stock OpenAI CLIP checkpoints (``ViT-L-14.pt``, a TorchScript archive)
  -> the TimeSformer bootstrap ``convert_openai_clip_checkpoint``: the
  reference's ``remap_keys`` (model/LaviLa.py:19-53) with a zero-initialised
  time attention, the text tower verbatim, fresh projections where the
  widths differ;
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
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .clip_text import TextConfig
from .lavila import Lavila, LavilaConfig
from .obj_decoder import DecoderConfig, ObjDecoder

__all__ = [
    "load_torch_state_dict",
    "convert_lavila_checkpoint",
    "convert_openai_clip_checkpoint",
    "convert_decoder_checkpoint",
    "inflate_temporal_embed",
]


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """``torch.load`` a checkpoint -> a state dict of f32 CPU tensors, the
    ``module.`` prefix stripped and an inner ``state_dict`` unwrapped.

    The reference's checkpoints carry pickled training arguments beside
    the weights, so they load with ``weights_only=False``: load only
    checkpoints you trust. The official OpenAI CLIP releases are
    TorchScript archives (the reference falls back to ``torch.jit.load``,
    openai_clip.py:151-160): the ScriptModule's ``state_dict()`` is taken."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    except RuntimeError:
        ckpt = torch.jit.load(path, map_location="cpu")
    if isinstance(ckpt, torch.jit.ScriptModule):
        ckpt = ckpt.state_dict()
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


def _resblock(sd, src: str, dst: str, out: dict):
    """A CLIP ``ResidualAttentionBlock`` -> the port's ``clip_text.TextBlock``."""
    _lin(sd, f"{src}.ln_1", f"{dst}.ln_1", out)
    _lin(sd, f"{src}.ln_2", f"{dst}.ln_2", out)
    _mha(sd, f"{src}.attn", f"{dst}.attn", out)
    _lin(sd, f"{src}.mlp.c_fc", f"{dst}.mlp_fc", out)
    _lin(sd, f"{src}.mlp.c_proj", f"{dst}.mlp_proj", out)


def _text_tower(sd, layers: int, dst: str, out: dict):
    """A CLIP text tower (its own key names) -> a ``clip_text.TextTransformer``
    whose keys start with ``dst``."""
    out[f"{dst}token_embedding"] = sd["token_embedding.weight"]
    for name in ("positional_embedding", "text_projection"):
        out[f"{dst}{name}"] = sd[name]
    _lin(sd, "ln_final", f"{dst}ln_final", out)
    for i in range(layers):
        _resblock(sd, f"transformer.resblocks.{i}", f"{dst}blocks.{i}", out)


def _assign(module: nn.Module, sd: dict) -> nn.Module:
    module.load_state_dict({k: v.contiguous() for k, v in sd.items()}, strict=True, assign=True)
    return module


def convert_lavila_checkpoint(sd: dict, cfg: LavilaConfig) -> Lavila:
    """A LaviLa CLIP state dict -> ``Lavila`` on the CPU.

    ``cfg`` gives the towers' shapes (depth, widths, vocabulary); the
    temporal embedding keeps the checkpoint's frame count (inflate it with
    ``inflate_temporal_embed``). As in the JAX package, what is present is
    converted: a vision-only checkpoint (a bare SpaceTimeTransformer, no
    ``token_embedding.weight``) gives a ``Lavila`` without a text tower,
    and ``image_projection`` / ``logit_scale`` are None where absent."""
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

    text = bool(cfg.text.layers) and "token_embedding.weight" in sd
    if text:
        _text_tower(sd, cfg.text.layers, "text.", out)
    if "image_projection" in sd:
        out["image_projection"] = sd["image_projection"]
    if "logit_scale" in sd:
        out["logit_scale"] = sd["logit_scale"].reshape(())

    t0 = sd["visual.temporal_embed"].shape[1]
    ckpt_cfg = replace(cfg, visual=replace(cfg.visual, num_frames=t0))
    module = Lavila(ckpt_cfg, text=text, device="meta")
    for name in ("image_projection", "logit_scale"):
        if name not in out:
            setattr(module, name, None)
    return _assign(module, out)


def _count(sd: dict, prefix: str, part: int) -> int:
    return 1 + max(int(k.split(".")[part]) for k in sd if k.startswith(prefix))


def _lavila_config(sd: dict, depth: int, text_layers: int, embed_dim: int) -> LavilaConfig:
    """The towers' shapes read off a LaviLa-layout state dict, a head 64
    wide as in CLIP's ``build_model``; ``embed_dim`` the projection width."""
    width, chans, patch, _ = sd["visual.patch_embed.proj.weight"].shape  # (D, C, P, P)
    grid = round((sd["visual.pos_embed"].shape[1] - 1) ** 0.5)
    vocab, tw = sd["token_embedding.weight"].shape
    return LavilaConfig(
        visual=replace(LavilaConfig().visual, img_size=grid * patch, patch_size=patch, in_chans=chans, width=width,
                       depth=depth, heads=width // 64, num_frames=sd["visual.temporal_embed"].shape[1]),
        text=TextConfig(vocab_size=vocab, context_length=sd["positional_embedding"].shape[0], width=tw,
                        heads=tw // 64, layers=text_layers, embed_dim=embed_dim),
        embed_dim=embed_dim,
    )


def convert_openai_clip_checkpoint(sd: dict, num_frames: int = 4, project_embed_dim: int = 256, seed: int = 0,
                                   cfg: LavilaConfig | None = None) -> Lavila:
    """A raw OpenAI CLIP state dict -> a TimeSformer ``Lavila`` (the
    bootstrap the reference's factory performs on from-scratch runs,
    run/train.py:425-431).

    ``remap_keys`` maps the CLIP ViT onto the TimeSformer's spatial weights
    (model/LaviLa.py:19-53); the temporal pieces get ``time_init='zeros'``
    (qkv zero, proj weight 1, ``norm3`` the identity: time attention
    starts as an identity residual, L:236-242) and a zero temporal
    embedding of ``num_frames``; the text tower loads verbatim
    (L:161-164). A projection is CLIP's where its output width is
    ``project_embed_dim``; otherwise it is drawn fresh with CLIP's init
    scheme from ``np.random.default_rng(seed)``, the image projection
    first (L:165-171, 637-640), so the draws equal the JAX package's.

    The depth and the text layers are read off ``sd``. ``cfg``, where
    given, must have them (else ``ValueError``; any other shape that
    differs fails the strict load) and sets the rest, the head counts;
    without it the shapes read off give the config (a head 64 wide).

    Args:
        sd: OpenAI CLIP keys (``visual.conv1.weight``,
            ``visual.transformer.resblocks.*``, ``transformer.resblocks.*``,
            ...), e.g. ``load_torch_state_dict`` of a stock ViT-L/14.
    """
    depth = _count(sd, "visual.transformer.resblocks.", 3)
    text_layers = _count(sd, "transformer.resblocks.", 2)
    width = sd["visual.class_embedding"].shape[-1]
    out = {
        "visual.patch_embed.proj.weight": sd["visual.conv1.weight"],
        "visual.cls_token": sd["visual.class_embedding"].reshape(1, 1, width),
        "visual.pos_embed": sd["visual.positional_embedding"][None],
        "visual.temporal_embed": torch.zeros(1, num_frames, width),
        "visual.ln_pre.weight": sd["visual.ln_pre.weight"],
        "visual.ln_pre.bias": sd["visual.ln_pre.bias"],
        "visual.norm.weight": sd["visual.ln_post.weight"],
        "visual.norm.bias": sd["visual.ln_post.bias"],
    }
    pairs = (("ln_1", "norm1"), ("ln_2", "norm2"), ("attn.out_proj", "attn.proj"), ("mlp.c_fc", "mlp.fc1"),
             ("mlp.c_proj", "mlp.fc2"))
    for i in range(depth):
        src, dst = f"visual.transformer.resblocks.{i}", f"visual.blocks.{i}"
        for f in ("weight", "bias"):
            for a, b in pairs:
                out[f"{dst}.{b}.{f}"] = sd[f"{src}.{a}.{f}"]
            out[f"{dst}.attn.qkv.{f}"] = sd[f"{src}.attn.in_proj_{f}"]
        # time_init='zeros': an identity time-attention residual at the start
        out[f"{dst}.norm3.weight"] = torch.ones(width)
        out[f"{dst}.norm3.bias"] = torch.zeros(width)
        out[f"{dst}.timeattn.qkv.weight"] = torch.zeros(3 * width, width)
        out[f"{dst}.timeattn.qkv.bias"] = torch.zeros(3 * width)
        out[f"{dst}.timeattn.proj.weight"] = torch.ones(width, width)
        out[f"{dst}.timeattn.proj.bias"] = torch.zeros(width)

    # the text tower's key names are the LaviLa checkpoint's
    for k in sd:
        if k.startswith(("transformer.", "token_embedding", "ln_final")) or k in ("positional_embedding",
                                                                                   "logit_scale"):
            out[k] = sd[k]

    rng = np.random.default_rng(seed)
    vis_proj = sd.get("visual.proj")
    if vis_proj is not None and vis_proj.shape[1] == project_embed_dim:
        out["image_projection"] = vis_proj
    else:
        out["image_projection"] = torch.from_numpy(
            rng.standard_normal((width, project_embed_dim)).astype(np.float32) * width**-0.5)
    txt_proj = sd.get("text_projection")
    if txt_proj is not None and txt_proj.shape[1] != project_embed_dim:
        tw = txt_proj.shape[0]
        txt_proj = torch.from_numpy(rng.standard_normal((tw, project_embed_dim)).astype(np.float32) * tw**-0.5)
    if txt_proj is not None:
        out["text_projection"] = txt_proj

    if cfg is None:
        cfg = _lavila_config(out, depth, text_layers, project_embed_dim)
    elif (cfg.visual.depth, cfg.text.layers) != (depth, text_layers):
        raise ValueError(f"the checkpoint has {depth} visual blocks and {text_layers} text layers, the config "
                         f"{cfg.visual.depth} and {cfg.text.layers}")
    return convert_lavila_checkpoint(out, cfg)


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
