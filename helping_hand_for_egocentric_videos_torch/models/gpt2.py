"""GPT-2 with LaViLa's gated cross-attention, over a static KV cache.

The language model of LaViLa's narrator (``lavila/models/gpt2_gated.py``:
``GatedGPT2``, HF's ``GPT2LMHeadModel`` with a cross-attention block in
every ``cross_attn_every``-th layer). Block ``i``:

- ``x += attn(ln_1 x)``: causal self-attention, ``c_attn`` d -> 3d and
  ``c_proj`` d -> d, both with bias, scores scaled by 1/sqrt(head_dim);
- if ``i % cross_attn_every == 0``: ``x += tanh(g_i) * xattn(ln_cross_attn
  x, latents)``, HF's ``GPT2Attention(is_cross_attention=True)``: ``q_attn``
  d -> d on the stream, ``c_attn`` d -> 2d (k | v) on the latents, both
  with bias, no mask, ``c_proj`` d -> d;
- ``x += mlp(ln_2 x)``: ``c_fc`` d -> n_inner, ``gelu_new`` (the tanh
  form), ``c_proj`` n_inner -> d.

Token and learned position embeddings in, ``ln_f`` out, and ``lm_head``
tied to ``wte``. The modules keep HF's names and its ``Conv1D`` layout
(weight (in, out), ``y = x W + b``), so a released state dict loads as it
is; ``conv1d`` multiplies by the transposed view, with no copy.

The narrator's sampling path: ``prefill_cross`` makes each cross layer's
keys and values once per clip into ``NarrateCache.cross`` (the clip's R
sequences read them without an expanded copy: at a decode step a clip's R
query rows attend its M keys as one (R, M) product); ``decode_step`` runs
one token of every sequence at position ``pos``, writes its keys and
values into the preallocated ``NarrateCache.kv`` and attends the cache up
to and including ``pos``. Teacher-forced logits of whole sequences are
these steps at every position.

Precision: the stream, weights and caches in the model's type (bf16 on the
card); LayerNorm statistics in f32 (``F.layer_norm`` of a bf16 input), the
attention's scores, softmax and sums in f32, and the logits in f32
(``lm_logits``: on the card one bf16 GEMM with an f32 output). Both
attention calls of a step go through ``ops/decode_attention.py``: on the
card the hand-written kernel K8, which takes bf16 at head width 64 and
raises on anything else (the self mode reads the query rows in place from
``c_attn``'s output, the cross mode a clip's keys once for its R rows,
both write the rows ``c_proj`` takes); on the CPU
``F.scaled_dot_product_attention``.

``models/step_graphs.py::Decoder`` holds one batch shape's cache and runs
``decode_step`` over it: on the card, once a batch has run the steps
eagerly, each position's step is recorded into a CUDA graph over the same
cache and replayed for every later batch, one launch a step in place of
about 1200. The narrator adds the K8 launches a replayed batch's graphs
hold to ``hh.narrate.decode_attn_kernel_calls``, as the eager step's
wrapper calls do.

Departures from the published forward, none of them in its arithmetic:
the cache layouts put the layer first ((layers, 2, N, H, S, dh) and
(cross layers, 2, B, H, M, dh)), so each layer's keys are one contiguous
block; the host passes ``pos`` as a Python int, so a step reads the cache
at its true length; the cross keys and values are held per clip, not per
sequence.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from ..ops import decode_attention
from ..utils.profiling import span

__all__ = ["GPT2Config", "GatedGPT2", "NarrateCache", "conv1d", "decode_step", "lm_logits",
           "prefill_cross"]


@dataclass(frozen=True)
class GPT2Config:
    """GPT-2 XL's shape (HF ``gpt2-xl``) and LaViLa's cross-attention period."""

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 1600
    n_layer: int = 48
    n_head: int = 25
    n_inner: int = 6400
    layer_norm_epsilon: float = 1e-5
    cross_attn_every: int = 2

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def has_cross(self, i: int) -> bool:
        return self.cross_attn_every > 0 and i % self.cross_attn_every == 0

    @property
    def cross_layers(self) -> tuple:
        return tuple(i for i in range(self.n_layer) if self.has_cross(i))


class Conv1D(nn.Module):
    """HF's ``Conv1D``: weight (in, out), bias (out,); GPT-2's init N(0, std), zero bias."""

    def __init__(self, d_in: int, d_out: int, *, std: float = 0.02, generator=None, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_in, d_out, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))
        if self.weight.device.type != "meta":
            with torch.no_grad():
                self.weight.normal_(0.0, std, generator=generator)


def conv1d(p: Conv1D, x):
    """``x W + b`` in ``x``'s type (the weight cast at use, free when it matches)."""
    return F.linear(x, p.weight.t().to(x.dtype), p.bias.to(x.dtype))


class _Attention(nn.Module):
    def __init__(self, cfg: GPT2Config, *, cross: bool, proj_std: float, generator=None, device=None):
        super().__init__()
        d = cfg.n_embd
        kw = {"generator": generator, "device": device}
        if cross:
            self.q_attn = Conv1D(d, d, **kw)
            self.c_attn = Conv1D(d, 2 * d, **kw)
        else:
            self.c_attn = Conv1D(d, 3 * d, **kw)
        self.c_proj = Conv1D(d, d, std=proj_std, **kw)


class _MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, *, proj_std: float, generator=None, device=None):
        super().__init__()
        kw = {"generator": generator, "device": device}
        self.c_fc = Conv1D(cfg.n_embd, cfg.n_inner, **kw)
        self.c_proj = Conv1D(cfg.n_inner, cfg.n_embd, std=proj_std, **kw)


class _Block(nn.Module):
    def __init__(self, cfg: GPT2Config, i: int, *, generator=None, device=None):
        super().__init__()
        kw = {"generator": generator, "device": device}
        d = cfg.n_embd
        proj_std = 0.02 / math.sqrt(2 * cfg.n_layer)  # GPT-2's scaled residual init
        self.ln_1 = nn.LayerNorm(d, eps=cfg.layer_norm_epsilon, device=device)
        self.attn = _Attention(cfg, cross=False, proj_std=proj_std, **kw)
        if cfg.has_cross(i):
            self.ln_cross_attn = nn.LayerNorm(d, eps=cfg.layer_norm_epsilon, device=device)
            self.crossattention = _Attention(cfg, cross=True, proj_std=proj_std, **kw)
            # LaViLa's init: 0, the video cut out until training opens the gate
            self.cross_attn_gate = nn.Parameter(torch.zeros(1, device=device))
        self.ln_2 = nn.LayerNorm(d, eps=cfg.layer_norm_epsilon, device=device)
        self.mlp = _MLP(cfg, proj_std=proj_std, **kw)


class _Transformer(nn.Module):
    def __init__(self, cfg: GPT2Config, *, generator=None, device=None):
        super().__init__()
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd, device=device)
        self.wpe = nn.Embedding(cfg.n_positions, cfg.n_embd, device=device)
        if self.wte.weight.device.type != "meta":
            with torch.no_grad():
                self.wte.weight.normal_(0.0, 0.02, generator=generator)
                self.wpe.weight.normal_(0.0, 0.01, generator=generator)
        self.h = nn.ModuleList(_Block(cfg, i, generator=generator, device=device) for i in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon, device=device)


class GatedGPT2(nn.Module):
    """Parameters of the language model, under HF's names
    (``transformer.wte``, ``transformer.h.<i>...``, ``transformer.ln_f``);
    ``lm_head`` is ``transformer.wte``."""

    def __init__(self, cfg: GPT2Config, *, generator=None, device=None):
        super().__init__()
        self.transformer = _Transformer(cfg, generator=generator, device=device)


def _ln(p: nn.LayerNorm, x, cfg: GPT2Config):
    """LayerNorm in the stream's type: torch's kernel keeps the statistics and
    the affine in f32 for a bf16 input, with no cast pass on either side."""
    return F.layer_norm(x, x.shape[-1:], p.weight.to(x.dtype), p.bias.to(x.dtype), cfg.layer_norm_epsilon)


def _heads(x, h: int):
    """(..., S, h * dh) -> (..., h, S, dh)."""
    return x.unflatten(-1, (h, -1)).transpose(-3, -2)


def _gelu_new(x):
    return F.gelu(x, approximate="tanh")


def lm_logits(lm: GatedGPT2, h):
    """``lm_head`` (tied to ``wte``) of the final-normed stream, in f32:
    on the card the bf16 product with an f32 output."""
    w = lm.transformer.wte.weight
    if h.dtype == torch.float32:
        return F.linear(h, w.float())
    if h.is_cuda:
        flat = torch.mm(h.reshape(-1, h.shape[-1]), w.t().to(h.dtype), out_dtype=torch.float32)
        return flat.reshape(*h.shape[:-1], -1)
    return F.linear(h.float(), w.float())


def _cross_kv(blk: _Block, cfg: GPT2Config, latents):
    """(B, M, d) latents -> the cross layer's (k, v), each (B, H, M, dh)."""
    k, v = conv1d(blk.crossattention.c_attn, latents).split(cfg.n_embd, dim=-1)
    return _heads(k, cfg.n_head), _heads(v, cfg.n_head)


def _mlp(blk: _Block, x):
    return conv1d(blk.mlp.c_proj, _gelu_new(conv1d(blk.mlp.c_fc, x)))


class NarrateCache:
    """The two kinds of attention state of one narrated batch of ``clips``
    clips of ``r`` sequences: ``kv`` (layers, 2, clips * r, H, length, dh),
    each layer's keys and values of every position so far, written by
    ``decode_step``; ``cross`` (cross layers, 2, clips, H, M, dh), each
    cross layer's keys and values of the clip's latents, written once by
    ``prefill_cross``. Both preallocated, so a step's shapes never change."""

    def __init__(self, cfg: GPT2Config, clips: int, r: int, length: int, latents: int, *, dtype, device):
        n, dh = clips * r, cfg.head_dim
        self.r = r
        self.kv = torch.empty(cfg.n_layer, 2, n, cfg.n_head, length, dh, dtype=dtype, device=device)
        self.cross = torch.empty(len(cfg.cross_layers), 2, clips, cfg.n_head, latents, dh, dtype=dtype, device=device)

    def write(self, layer: int, k, v, pos: int):
        """Store one step's (N, H, dh) keys and values at ``pos``."""
        self.kv[layer, 0, :, :, pos] = k
        self.kv[layer, 1, :, :, pos] = v

    @property
    def nbytes(self) -> tuple:
        """(bytes of the self-attention cache, bytes of the cross cache)."""
        return (self.kv.numel() * self.kv.element_size(), self.cross.numel() * self.cross.element_size())


def prefill_cross(lm: GatedGPT2, cfg: GPT2Config, latents, cache: NarrateCache):
    """Each cross layer's keys and values of the (B, M, d) latents, once per
    clip, into ``cache.cross``."""
    for j, i in enumerate(cfg.cross_layers):
        k, v = _cross_kv(lm.transformer.h[i], cfg, latents)
        cache.cross[j, 0] = k
        cache.cross[j, 1] = v


def _self_attend(blk: _Block, cfg: GPT2Config, h, cache: NarrateCache, i: int, pos: int, device):
    """One step's causal self-attention of (N, d) rows over the cache."""
    n = h.shape[0]
    q, k, v = conv1d(blk.attn.c_attn, h).view(n, 3, cfg.n_head, cfg.head_dim).unbind(1)
    cache.write(i, k, v, pos)
    with span("hh.narrate.decode.attn", device):
        out = decode_attention.self_attention(q, cache.kv[i, 0], cache.kv[i, 1], pos + 1)
    return conv1d(blk.attn.c_proj, out)


def cross_attend(blk: _Block, cfg: GPT2Config, h, cache: NarrateCache, j: int, device):
    """One step's gated cross-attention of (N, d) rows: a clip's r query
    rows against its M keys of ``cache.cross[j]``, scaled by tanh(gate)."""
    q = conv1d(blk.crossattention.q_attn, h).view(h.shape[0], cfg.n_head, cfg.head_dim)
    with span("hh.narrate.decode.attn", device):
        out = decode_attention.cross_attention(q, cache.cross[j, 0], cache.cross[j, 1], cache.r)
    out = conv1d(blk.crossattention.c_proj, out)
    return torch.tanh(blk.cross_attn_gate).to(out.dtype) * out


def decode_step(lm: GatedGPT2, cfg: GPT2Config, cache: NarrateCache, ids, pos: int):
    """One token of every sequence: (N,) ids at position ``pos`` -> f32
    logits (N, V), its keys and values written into ``cache``."""
    tr = lm.transformer
    device = ids.device
    x = (tr.wte.weight[ids] + tr.wpe.weight[pos]).to(cache.kv.dtype)
    j = 0
    for i, blk in enumerate(tr.h):
        x = x + _self_attend(blk, cfg, _ln(blk.ln_1, x, cfg), cache, i, pos, device)
        if cfg.has_cross(i):
            x = x + cross_attend(blk, cfg, _ln(blk.ln_cross_attn, x, cfg), cache, j, device)
            j += 1
        x = x + _mlp(blk, _ln(blk.ln_2, x, cfg))
    return lm_logits(lm, _ln(tr.ln_f, x, cfg))
