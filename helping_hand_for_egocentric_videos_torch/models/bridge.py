"""Load parameter trees in the JAX package's layout into the port's modules.

The JAX package keeps parameters as nested dicts (pytrees). This module
takes such a tree with numpy arrays as leaves (``np.asarray`` of each
leaf is taken, so any array type numpy reads will do) and turns it into a
state dict of the port's modules:

- a Linear ``{"w": (in, out), "b": (out,)}`` becomes ``weight`` (out, in)
  and ``bias``; the flat (P*P*C, D) patchifier and the decoder's bias-free
  ``proj`` are Linears without ``b``;
- a LayerNorm ``{"g", "b"}`` becomes ``weight`` and ``bias``;
- blocks stacked on a leading depth axis (``blocks`` of the visual and
  text towers, ``layers`` of the decoder) become ``blocks.<i>.``;
- lists (``bbox_mlp``, ``obj_proj``) become ``<name>.<i>.``;
- the text and decoder attention keep per-matrix ``wq/wk/wv/wo`` Linears,
  while the visual tower keeps its packed ``qkv`` Linear: both are plain
  Linears to the bridge;
- any other array (embeddings, projections, ``logit_scale``) is copied
  as it is.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .lavila import Lavila, LavilaConfig
from .obj_decoder import DecoderConfig, ObjDecoder

__all__ = ["jax_tree_to_state_dict", "load_jax_params", "from_jax_params"]

_STACKED = ("blocks", "layers")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_index(v, i) for v in tree]
    return np.asarray(tree)[i]


def _flatten(tree, prefix: str, out: dict):
    if isinstance(tree, dict):
        if "w" in tree:  # Linear, (in, out) -> torch (out, in)
            out[prefix + "weight"] = _tensor(tree["w"]).T.contiguous()
            if "b" in tree:
                out[prefix + "bias"] = _tensor(tree["b"])
            return
        if "g" in tree:  # LayerNorm
            out[prefix + "weight"] = _tensor(tree["g"])
            out[prefix + "bias"] = _tensor(tree["b"])
            return
        for k, v in tree.items():
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
    match (``strict``). Returns the module."""
    module.load_state_dict(jax_tree_to_state_dict(tree), strict=True)
    return module


def from_jax_params(backbone, decoder, lavila_cfg: LavilaConfig, dec_cfg: DecoderConfig):
    """The JAX ``init_lavila_params`` / ``init_decoder_params`` trees ->
    (Lavila, ObjDecoder) on the CPU holding the same weights."""
    return (
        load_jax_params(Lavila(lavila_cfg), backbone),
        load_jax_params(ObjDecoder(dec_cfg), decoder),
    )
