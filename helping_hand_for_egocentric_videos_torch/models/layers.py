"""NN primitives shared by the models.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/models/layers.py``.
Parameters live in ``nn.Module`` containers (``nn.Linear`` with torch's
(out, in) weight, ``nn.LayerNorm``, ``MultiheadAttention``); the forward
math is plain functions over them, so each model's forward reads like its
JAX counterpart. Weights are cast to the activations' type at use, which
is free when they already match. Initialisers take a ``torch.Generator``
and mirror the JAX ``*_init`` functions' distributions. Dropout draws
from a ``torch.Generator`` the caller passes; without one there is none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .quant import QuantLinear, int8_linear, mixed_linear

__all__ = [
    "linear_init",
    "linear",
    "row_linear",
    "layer_norm_init",
    "layer_norm",
    "quick_gelu",
    "MultiheadAttention",
    "multi_head_attention",
    "dropout",
]


def linear_init(d_in: int, d_out: int, *, bias: bool = True, std: float | None = None,
                generator=None, device=None) -> nn.Linear:
    """Torch-Linear-style init: U(-1/sqrt(in), 1/sqrt(in)) weight, or
    normal(std); the bias is always U(-1/sqrt(in), 1/sqrt(in))."""
    lin = nn.utils.skip_init(nn.Linear, d_in, d_out, bias=bias, device=device or "cpu")
    bound = d_in**-0.5
    with torch.no_grad():
        if std is None:
            lin.weight.uniform_(-bound, bound, generator=generator)
        else:
            lin.weight.normal_(0.0, std, generator=generator)
        if bias:
            lin.bias.uniform_(-bound, bound, generator=generator)
    return lin


def linear(p, x):
    """``p`` an ``nn.Linear``, or a ``quant.QuantLinear`` (int8 weights):
    with the fallback flag ``q_on`` it takes ``mixed_linear``, else the
    dynamic-activation ``int8_linear``."""
    if isinstance(p, QuantLinear):
        return int8_linear(p, x) if p.q_on is None else mixed_linear(p, x)
    bias = None if p.bias is None else p.bias.to(x.dtype)
    return F.linear(x, p.weight.to(x.dtype), bias)


def row_linear(p: nn.Linear, x, mp=None):
    """``linear`` of a weight that holds this rank's input features (its
    ``x`` is this rank's part of the input): the partial products in f32,
    summed over the model group of ``mp`` (a ``parallel.ModelParallel``),
    then the bias, rounded once to ``x``'s type, as the one-card matmul
    rounds. ``mp`` None is ``linear``. Outside autograd only."""
    if mp is None:
        return linear(p, x)
    w = p.weight.to(x.dtype)
    if x.dtype == torch.float32:
        part = F.linear(x, w)
    elif x.is_cuda:  # the product of bf16 operands kept in f32
        part = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32).reshape(*x.shape[:-1], -1)
    else:
        part = F.linear(x.float(), w.float())
    part = mp.all_reduce(part)
    if p.bias is not None:
        part = part + p.bias.float()
    return part.to(x.dtype)


def layer_norm_init(dim: int, device=None) -> nn.LayerNorm:
    """A parameter container (weight 1, bias 0); use ``layer_norm``."""
    return nn.LayerNorm(dim, device=device)


def layer_norm(p: nn.LayerNorm, x, eps: float = 1e-5):
    """Statistics and affine in f32 even for bf16 activations; the result
    is cast back to the input type."""
    y = F.layer_norm(x.float(), x.shape[-1:], p.weight.float(), p.bias.float(), eps)
    return y.to(x.dtype)


def quick_gelu(x):
    """OpenAI CLIP's QuickGELU: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class MultiheadAttention(nn.Module):
    """Per-matrix q/k/v/out projections (the JAX ``mha_init`` layout)."""

    def __init__(self, dim: int, *, qkv_bias: bool = True, generator=None, device=None):
        super().__init__()
        kw = {"generator": generator, "device": device}
        self.wq = linear_init(dim, dim, bias=qkv_bias, **kw)
        self.wk = linear_init(dim, dim, bias=qkv_bias, **kw)
        self.wv = linear_init(dim, dim, bias=qkv_bias, **kw)
        self.wo = linear_init(dim, dim, bias=True, **kw)


def _split_heads(x, num_heads: int):
    b, n, d = x.shape
    return x.reshape(b, n, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, n, dh = x.shape
    return x.transpose(1, 2).reshape(b, n, h * dh)


def multi_head_attention(p: MultiheadAttention, q_in, k_in, v_in, num_heads: int, mask=None,
                         return_probs: bool = False, generator=None, dropout_rate: float = 0.0, mp=None):
    """torch.nn.MultiheadAttention semantics, batch first.

    q_in/k_in/v_in: (B, Nq/Nk, D). ``mask``: additive float mask
    broadcastable to (B, H, Nq, Nk). The softmax runs in f32. With
    ``return_probs`` also returns the head-averaged weights (B, Nq, Nk).
    ``generator``/``dropout_rate``: nn.MultiheadAttention's dropout of the
    softmax weights (inverted-scaled, not renormalised), drawn only when a
    generator is given; ``return_probs`` reports the weights before it.
    ``mp``: a ``parallel.ModelParallel`` whose rank holds ``num_heads``
    heads of wq/wk/wv (column-split) and their input columns of ``wo``
    (row-split, ``row_linear``).
    """
    q = _split_heads(linear(p.wq, q_in), num_heads)
    k = _split_heads(linear(p.wk, k_in), num_heads)
    v = _split_heads(linear(p.wv, v_in), num_heads)
    dh = q.shape[-1]
    logits = (q @ k.transpose(-1, -2)) * (dh**-0.5)
    if mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = row_linear(p.wo, _merge_heads(dropout(generator, probs, dropout_rate) @ v), mp)
    if return_probs:
        return out, probs.mean(dim=1)
    return out


def dropout(generator, x, rate: float, deterministic: bool = False):
    """Inverted dropout: keep each value with probability ``1 - rate`` and
    scale it by ``1 / (1 - rate)``. Off when ``deterministic``, at rate 0,
    or without a generator (which must be on ``x``'s device)."""
    if deterministic or rate == 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)
