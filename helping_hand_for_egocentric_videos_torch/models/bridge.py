"""Load parameter trees in the JAX package's layout into the port's modules.

The JAX package keeps parameters as nested dicts (pytrees). This module
takes such a tree with numpy arrays as leaves (``np.asarray`` of each
leaf is taken, so any array type numpy reads will do) and turns it into a
state dict of the port's modules:

- a Linear ``{"w": (in, out), "b": (out,)}`` becomes ``weight`` (out, in)
  and ``bias``; the flat (P*P*C, D) patchifier and the decoder's bias-free
  ``proj`` are Linears without ``b``;
- a LayerNorm ``{"g", "b"}`` becomes ``weight`` and ``bias``;
- a conv ``{"w": (kh, kw, in, out)}`` (HWIO) becomes ``weight`` (out, in,
  kh, kw), and a BatchNorm ``{"g", "b", "mean", "var"}`` ``weight``,
  ``bias``, ``running_mean`` and ``running_var`` (the CLIP ResNet tower);
  its blocks' ``stride`` (an int, not a weight) is left out, so
  ``load_jax_params(ClipResNet(cfg), tree)`` loads a JAX ResNet tower;
- blocks stacked on a leading depth axis (``blocks`` of the visual and
  text towers, ``layers`` of the decoder) become ``blocks.<i>.``;
- lists (``bbox_mlp``, ``obj_proj``) become ``<name>.<i>.``;
- the text and decoder attention keep per-matrix ``wq/wk/wv/wo`` Linears,
  while the visual tower keeps its packed ``qkv`` Linear: both are plain
  Linears to the bridge;
- a quantized Linear ``{"w_q": (in, out) int8, "s_w": (out,), "b"?}``
  (``quant.quantize_lavila_params`` of the JAX package), with the
  fallback's ``"q_on"`` and float ``"w"`` where it has them, becomes the
  buffers of a ``quant.QuantLinear``: ``w_q`` (out, in) int8, ``s_w``,
  ``bias``, ``q_on`` and ``weight``; ``load_jax_params`` puts a
  QuantLinear in the module wherever the tree has one, so a JAX-quantized
  tree and a port-quantized module hold the same codes;
- any other array (embeddings, projections, ``logit_scale``) is copied
  as it is.

The CLIP ViT's flat (P*P*3, width) patchifier becomes the (width, 3, P, P)
conv of ``clip_image.ClipVisionTransformer`` (``clip_vit_from_jax``); a
tree without ``text`` (a vision-only LaviLa checkpoint) loads into a
``Lavila`` without a text tower (``lavila_from_jax``).

Float leaves become f32 tensors; int8 codes and bool flags keep their
types.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .clip_image import ClipVisionTransformer, ClipVitConfig
from .lavila import Lavila, LavilaConfig
from .obj_decoder import DecoderConfig, ObjDecoder
from .quant import QuantLinear

__all__ = [
    "jax_tree_to_state_dict",
    "load_jax_params",
    "from_jax_params",
    "lavila_from_jax",
    "clip_vit_from_jax",
]

_STACKED = ("blocks", "layers")


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype in (np.int8, np.bool_):
        return torch.from_numpy(np.array(a))
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_index(v, i) for v in tree]
    return np.asarray(tree)[i]


def _flatten(tree, prefix: str, out: dict):
    if isinstance(tree, dict):
        if "w_q" in tree:  # quantized Linear (it may hold the fallback's "w" too)
            out[prefix + "w_q"] = _tensor(tree["w_q"]).T.contiguous()
            out[prefix + "s_w"] = _tensor(tree["s_w"])
            if "b" in tree:
                out[prefix + "bias"] = _tensor(tree["b"])
            if "q_on" in tree:
                out[prefix + "q_on"] = _tensor(tree["q_on"])
                out[prefix + "weight"] = _tensor(tree["w"]).T.contiguous()
            return
        if "w" in tree and np.ndim(tree["w"]) == 4:  # conv, HWIO -> torch (out, in, kh, kw)
            out[prefix + "weight"] = _tensor(tree["w"]).permute(3, 2, 0, 1).contiguous()
            return
        if "w" in tree:  # Linear, (in, out) -> torch (out, in)
            out[prefix + "weight"] = _tensor(tree["w"]).T.contiguous()
            if "b" in tree:
                out[prefix + "bias"] = _tensor(tree["b"])
            return
        if "g" in tree:  # LayerNorm, or BatchNorm with its running statistics
            out[prefix + "weight"] = _tensor(tree["g"])
            out[prefix + "bias"] = _tensor(tree["b"])
            if "mean" in tree:
                out[prefix + "running_mean"] = _tensor(tree["mean"])
                out[prefix + "running_var"] = _tensor(tree["var"])
            return
        for k, v in tree.items():
            if k == "stride":
                continue
            if k in _STACKED:
                depth = len(np.asarray(_first_leaf(v)))
                for i in range(depth):
                    _flatten(_index(v, i), f"{prefix}{k}.{i}.", out)
            else:
                _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = _tensor(tree)


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def jax_tree_to_state_dict(tree) -> dict[str, torch.Tensor]:
    """A JAX-layout parameter tree -> a state dict of f32 CPU tensors."""
    out: dict[str, torch.Tensor] = {}
    _flatten(tree, "", out)
    return out


def load_jax_params(module: nn.Module, tree) -> nn.Module:
    """Load a JAX-layout tree into ``module``; every key and shape must
    match (``strict``). Where the tree holds a quantized Linear, the
    module's Linear is replaced by a ``QuantLinear``. Returns the module."""
    sd = jax_tree_to_state_dict(tree)
    for key in [k for k in sd if k.endswith(".w_q")]:
        path = key[: -len(".w_q")]
        parent, _, name = path.rpartition(".")
        w_q, s_w, bias, weight, q_on = (sd.get(f"{path}.{f}") for f in ("w_q", "s_w", "bias", "weight", "q_on"))
        setattr(module.get_submodule(parent), name, QuantLinear(w_q, s_w, bias, weight=weight, q_on=q_on))
    module.load_state_dict(sd, strict=True)
    return module


def from_jax_params(backbone, decoder, lavila_cfg: LavilaConfig, dec_cfg: DecoderConfig):
    """The JAX ``init_lavila_params`` / ``init_decoder_params`` trees ->
    (Lavila, ObjDecoder) on the CPU holding the same weights."""
    return (
        load_jax_params(Lavila(lavila_cfg), backbone),
        load_jax_params(ObjDecoder(dec_cfg), decoder),
    )


def lavila_from_jax(tree, cfg: LavilaConfig) -> Lavila:
    """A JAX LaviLa tree (``convert_lavila_checkpoint``'s, vision-only or
    not) -> ``Lavila`` on the CPU: without a text tower where the tree has
    no ``text``, without ``image_projection`` / ``logit_scale`` where it
    has none."""
    module = Lavila(cfg, text="text" in tree)
    for name in ("image_projection", "logit_scale"):
        if name not in tree:
            setattr(module, name, None)
    return load_jax_params(module, tree)


def clip_vit_from_jax(tree, cfg: ClipVitConfig) -> ClipVisionTransformer:
    """A JAX CLIP ViT tree (``init_clip_vit_params`` or
    ``convert_openai_vit_tower``) -> ``ClipVisionTransformer`` on the CPU."""
    tree = dict(tree)
    w = _tensor(tree.pop("patch_embed")["w"])  # (P*P*3, width), (ph, pw, c) order
    p = cfg.patch_size
    sd = jax_tree_to_state_dict(tree)
    sd["conv1.weight"] = w.reshape(p, p, 3, cfg.width).permute(3, 2, 0, 1).contiguous()
    module = ClipVisionTransformer(cfg)
    module.load_state_dict(sd, strict=True)
    return module
