"""CLIP text tower (OpenAI architecture) in PyTorch.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/models/clip_text.py``:
token + positional embedding -> pre-norm residual attention blocks with a
causal mask (-1e9 above the diagonal) and QuickGELU MLPs -> ln_final; the
sentence embedding is the ln_final output at the EOT position (the argmax
of the token ids, EOT having the largest id) times ``text_projection``.

Under the mesh's model axis (``parallel/tensor.py``) each rank holds a
slice of the vocabulary of ``token_embedding`` (a token outside it looks
up zeros, and the sum over the model group is the lookup), its heads of
wq/wk/wv and its input columns of wo, and its hidden units of mlp_fc and
mlp_proj: two all-reduces a block (``layers.row_linear``), plus one for
the embedding; the residual stream and the LayerNorms are whole on every
rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .layers import (
    MultiheadAttention,
    layer_norm,
    layer_norm_init,
    linear,
    linear_init,
    multi_head_attention,
    quick_gelu,
    row_linear,
)

__all__ = ["TextConfig", "TextTransformer", "encode_text"]


@dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 768
    heads: int = 12
    layers: int = 12
    embed_dim: int = 256  # projection dim
    ln_eps: float = 1e-5


class TextBlock(nn.Module):
    """CLIP ``initialize_parameters``: q/k/v ~ N(0, width^-0.5) drawn
    independently, out_proj ~ N(0, proj_std)."""

    def __init__(self, cfg: TextConfig, *, generator=None, device=None):
        super().__init__()
        kw = {"generator": generator, "device": device}
        width = cfg.width
        attn_std = width**-0.5
        proj_std = (width**-0.5) * ((2 * cfg.layers) ** -0.5)
        fc_std = (2 * width) ** -0.5
        self.ln_1 = layer_norm_init(width, device)
        self.attn = MultiheadAttention(width, **kw)
        self.ln_2 = layer_norm_init(width, device)
        self.mlp_fc = linear_init(width, width * 4, std=fc_std, **kw)
        self.mlp_proj = linear_init(width * 4, width, std=proj_std, **kw)
        with torch.no_grad():
            for lin in (self.attn.wq, self.attn.wk, self.attn.wv):
                lin.weight.normal_(0.0, attn_std, generator=generator)
            self.attn.wo.weight.normal_(0.0, proj_std, generator=generator)


class TextTransformer(nn.Module):
    """Parameters of the text tower (mirrors ``init_text_params``); the
    forward is ``encode_text``."""

    def __init__(self, cfg: TextConfig, *, generator=None, device=None):
        super().__init__()
        kw = {"generator": generator, "device": device}
        self.token_embedding = nn.Parameter(
            torch.randn(cfg.vocab_size, cfg.width, device=device, generator=generator) * 0.02
        )
        self.positional_embedding = nn.Parameter(
            torch.randn(cfg.context_length, cfg.width, device=device, generator=generator) * 0.01
        )
        self.blocks = nn.ModuleList(TextBlock(cfg, **kw) for _ in range(cfg.layers))
        self.ln_final = layer_norm_init(cfg.width, device)
        self.text_projection = nn.Parameter(
            torch.randn(cfg.width, cfg.embed_dim, device=device, generator=generator) * cfg.width**-0.5
        )


def _block_forward(p: TextBlock, x, mask, heads: int, eps: float, mp=None):
    h = layer_norm(p.ln_1, x, eps)
    x = x + multi_head_attention(p.attn, h, h, h, heads, mask=mask, mp=mp)
    h = layer_norm(p.ln_2, x, eps)
    return x + row_linear(p.mlp_proj, quick_gelu(linear(p.mlp_fc, h)), mp)


def _embed(table, tokens, vocab: int, mp=None):
    """``table[tokens]``; with ``mp``, ``table`` holds this rank's rows of
    the ``vocab`` rows (``parallel.tensor.shard_lavila``'s cut: the first
    ``vocab % size`` ranks one more) and the lookup is the sum over the
    model group of each rank's rows, zero outside them."""
    if mp is None:
        return table[tokens]
    base, extra = divmod(vocab, mp.size)
    lo, rows = mp.rank * base + min(mp.rank, extra), table.shape[0]
    local = tokens - lo
    inside = (local >= 0) & (local < rows)
    return mp.all_reduce(torch.where(inside[..., None], table[local.clamp(0, rows - 1)], 0.0))


def encode_text(params: TextTransformer, cfg: TextConfig, tokens, *, dtype=torch.float32, mp=None):
    """tokens: (B, L) int -> (text_embed (B, embed_dim), feature_map (B, L, width)).

    ``text_embed`` is the projected EOT feature (not normalised);
    ``feature_map`` is the ln_final output the decoder's txt_proj reads.
    ``params`` None (a vision-only ``Lavila``'s ``text``) raises. ``mp``: a
    ``parallel.ModelParallel`` whose rank holds the shard ``params`` (the
    module docstring); every rank of its group gets the whole outputs.
    """
    if params is None:
        raise ValueError("this backbone has no text tower (a vision-only checkpoint): it cannot embed text")
    b, n = tokens.shape
    heads = cfg.heads if mp is None else cfg.heads // mp.size
    x = _embed(params.token_embedding, tokens, cfg.vocab_size, mp).to(dtype)
    x = x + params.positional_embedding[:n].to(dtype)
    causal = torch.full((n, n), -1e9, dtype=torch.float32, device=tokens.device).triu(1)
    for blk in params.blocks:
        x = _block_forward(blk, x, causal, heads, cfg.ln_eps, mp)
    x = layer_norm(params.ln_final, x, cfg.ln_eps)
    eot = tokens.argmax(dim=-1)
    x_cls = x[torch.arange(b, device=tokens.device), eot] @ params.text_projection.to(dtype)
    return x_cls, x
