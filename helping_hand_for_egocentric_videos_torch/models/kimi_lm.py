"""Kimi-VL-A3B's language model (moonshotai/Kimi-VL-A3B-Instruct, the
DeepSeek-V3-shaped ``text_config``; arXiv:2504.07491), over a per-clip
prefix cache of latents.

Layer ``i`` of ``num_hidden_layers`` (27 at hidden size 2048):

- ``x += o_proj(MLA(input_layernorm(x)))``: multi-head latent attention,
  16 heads, ``q_lora_rank`` null: ``q = q_proj(h)`` split per head into
  ``q_nope`` (128) and ``q_pe`` (64); ``kv_a_proj_with_mqa(h)`` gives the
  latent ``c`` (512), normalised by ``kv_a_layernorm`` (RMSNorm), and one
  rotary key ``k_pe`` (64) shared by the heads; ``kv_b_proj(c)`` gives
  each head's ``k_nope`` (128) and ``v`` (128); scores
  ``(q_nope . k_nope + q_pe . k_pe) / sqrt(192)``, causal.
- ``x += mlp(post_attention_layernorm(x))``: below
  ``first_k_dense_replace`` a SwiGLU MLP of width ``intermediate_size``
  (11264); above it a mixture of experts: the router
  ``sigmoid(gate(h))`` in f32 picks ``num_experts_per_tok`` (6) of
  ``n_routed_experts`` (64) by ``sigmoid + e_score_correction_bias``
  (``noaux_tc`` with one group) and weights them by the sigmoid alone,
  normalised to sum 1 (``norm_topk_prob``) and scaled by
  ``routed_scaling_factor`` (2.446); each expert is a SwiGLU MLP of width
  ``moe_intermediate_size`` (1408); ``n_shared_experts`` (2) shared ones,
  one SwiGLU MLP of width 2 x 1408, see every token.
- RMSNorm (``rms_norm_eps``; ``kv_a_layernorm`` at ``kv_norm_eps``), RoPE
  at ``rope_theta`` on the 64 rotary dimensions, its pairs as
  DeepSeek-V3's modeling code pairs them (columns 2i and 2i + 1, rotated
  by ``pos * theta^(-2i/64)`` and written de-interleaved: the pairs'
  first members, then their second), a final ``norm`` and an untied
  ``lm_head`` over 163840 words.

Layout (``KimiLM.state_dict()``): HF's names under ``model.`` and
``lm_head``, with two departures that change no arithmetic: each gate
and up projection is one ``gate_up_proj`` (gate rows first), and a MoE
layer's experts are stacked, ``mlp.experts.gate_up_proj`` (G, 2 I, H)
and ``mlp.experts.down_proj`` (G, H, I) with G = 64 + 2: groups 0..63 the
routed experts, 64 and 65 the two halves of the shared MLP's width (the
shared MLP of width 2 I is exactly the sum of those two experts of width
I). So one grouped GEMM a projection runs the routed and the shared
experts of every token.

Two forms of MLA (``models/narrator.py::KimiNarratorModel`` runs them):

- ``prefill``: explicit attention of each clip's prefix (its visual
  tokens and prompt ids) over itself, causal, writing every layer's
  normalised latent and rotated key (576 values a position) into
  ``LatentCache.prefix``, once a clip. The last layer needs only its
  latents: its attention output and MLP of the prefix are never read.
- ``decode_step``: one token of every sequence, absorbed: ``q_nope .
  W_uk`` maps each head's query into the 512-wide latent, the scores are
  ``q_lat . c + q_pe . k_pe`` over the clip's prefix (read once for its
  R x 16 query rows) and the sequence's own tail (``LatentCache.tail``,
  written at ``pos``), one softmax over both
  (``ops/latent_attention.py``), and ``W_uv`` after the weighted sum.

The experts (``moe``): the token-expert rows, the shared groups
appended, sorted by group with ``torch.sort`` (one-byte keys), the
groups' ends found by ``torch.searchsorted``, all on the device, then one
``torch._grouped_mm`` a projection, each row's activation scaled by its
weight before ``down_proj`` (the product is linear in it); the outputs
back in token order and summed (f32 accumulation, one rounding). No count is read to the host, so a decode step records into one
CUDA graph (``models/step_graphs.py::Decoder``).

Precision: bf16 weights, stream and caches on the card; the router's
GEMM and sigmoid in f32 (its weight cast at use); RMSNorm statistics in f32 (``F.rms_norm``);
RoPE in f32; the attention's scores and softmax in f32; the logits in
f32 (one bf16 GEMM with an f32 output).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import latent_attention
from ..utils.profiling import count, span

__all__ = ["KimiLM", "KimiLMConfig", "LatentCache", "apply_rope", "decode_step", "experts_hit",
           "kimi_lm_tiny_config", "latent_attend", "lm_logits", "moe", "prefill", "rope_table", "route"]


@dataclass(frozen=True)
class KimiLMConfig:
    """Kimi-VL-A3B-Instruct's ``text_config`` (DeepSeek-V3's shape)."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    first_k_dense_replace: int = 1
    rms_norm_eps: float = 1e-5
    kv_norm_eps: float = 1e-6  # kv_a_layernorm's: DeepseekV3RMSNorm's default, the config states none
    rope_theta: float = 800000.0
    max_position_embeddings: int = 131072

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a position a layer in the cache: the latent and the rotary key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def groups(self) -> int:
        """The stacked experts: the routed ones, then the shared MLP's halves."""
        return self.n_routed_experts + self.n_shared_experts

    @property
    def moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace


def kimi_lm_tiny_config(**overrides) -> KimiLMConfig:
    """A miniature for tests: hidden 64, 4 heads, latent 32, rotary 8, 3
    layers (1 dense, 2 MoE), 8 experts with 2 a token and 1 shared, a
    512-word vocabulary."""
    base = dict(vocab_size=512, hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
                num_hidden_layers=3, num_attention_heads=4, n_shared_experts=1, n_routed_experts=8,
                num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                max_position_embeddings=256)
    return KimiLMConfig(**{**base, **overrides})


def _normal(p, std, generator):
    if p.device.type != "meta":
        with torch.no_grad():
            p.normal_(0.0, std, generator=generator)
    return p


def _linear(d_in, d_out, generator, device):
    lin = nn.Linear(d_in, d_out, bias=False, device=device)
    _normal(lin.weight, d_in**-0.5, generator)
    return lin


class RMSNorm(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))


class MLA(nn.Module):
    def __init__(self, cfg: KimiLMConfig, generator=None, device=None):
        super().__init__()
        h, nh = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj = _linear(h, nh * cfg.q_head_dim, generator, device)
        self.kv_a_proj_with_mqa = _linear(h, cfg.latent_dim, generator, device)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, device)
        self.kv_b_proj = _linear(cfg.kv_lora_rank, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim), generator, device)
        self.o_proj = _linear(nh * cfg.v_head_dim, h, generator, device)


class DenseMLP(nn.Module):
    def __init__(self, cfg: KimiLMConfig, generator=None, device=None):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_up_proj = _linear(h, 2 * i, generator, device)
        self.down_proj = _linear(i, h, generator, device)


class Gate(nn.Module):
    def __init__(self, cfg: KimiLMConfig, generator=None, device=None):
        super().__init__()
        self.weight = _normal(nn.Parameter(torch.empty(cfg.n_routed_experts, cfg.hidden_size, device=device)),
                              cfg.hidden_size**-0.5, generator)
        # trained to balance the experts' load; seeded not zero, so selection and weighting differ
        self.e_score_correction_bias = _normal(nn.Parameter(torch.empty(cfg.n_routed_experts, device=device)),
                                               0.1, generator)


class Experts(nn.Module):
    def __init__(self, cfg: KimiLMConfig, generator=None, device=None):
        super().__init__()
        g, h, i = cfg.groups, cfg.hidden_size, cfg.moe_intermediate_size
        self.gate_up_proj = _normal(nn.Parameter(torch.empty(g, 2 * i, h, device=device)), h**-0.5, generator)
        self.down_proj = _normal(nn.Parameter(torch.empty(g, h, i, device=device)), i**-0.5, generator)


class MoE(nn.Module):
    def __init__(self, cfg: KimiLMConfig, generator=None, device=None):
        super().__init__()
        self.gate = Gate(cfg, generator, device)
        self.experts = Experts(cfg, generator, device)


class Layer(nn.Module):
    def __init__(self, cfg: KimiLMConfig, i: int, generator=None, device=None):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, device)
        self.self_attn = MLA(cfg, generator, device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, device)
        mlp = DenseMLP if i < cfg.first_k_dense_replace else MoE
        self.mlp = mlp(cfg, generator, device)


class _Model(nn.Module):
    def __init__(self, cfg: KimiLMConfig, generator=None, device=None):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        _normal(self.embed_tokens.weight, 1.0, generator)
        self.layers = nn.ModuleList(Layer(cfg, i, generator, device) for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, device)


class KimiLM(nn.Module):
    """Parameters of the language model under HF's names (``model.*``,
    ``lm_head``; module docstring for the stacked experts). Random weights
    from ``generator``: every matrix N(0, 1/fan_in), the embedding N(0, 1),
    the correction bias N(0, 0.1), norms 1."""

    def __init__(self, cfg: KimiLMConfig, *, generator=None, device=None):
        super().__init__()
        self.model = _Model(cfg, generator, device)
        self.lm_head = _linear(cfg.hidden_size, cfg.vocab_size, generator, device)


def _rms(p: RMSNorm, x, eps: float):
    return F.rms_norm(x, x.shape[-1:], p.weight.to(x.dtype), eps)


def rope_table(cfg: KimiLMConfig, positions: int, device):
    """(cos, sin), each (positions, rope / 2) f32: pair i at position p turns
    by p * theta^(-2i / rope)."""
    d = cfg.qk_rope_head_dim
    inv = 1.0 / cfg.rope_theta ** (torch.arange(0, d, 2, device=device, dtype=torch.float32) / d)
    ang = torch.arange(positions, device=device, dtype=torch.float32)[:, None] * inv
    return ang.cos(), ang.sin()


def apply_rope(x, cos, sin):
    """(..., rope) rows turned pair by pair (columns 2i, 2i + 1), in f32,
    written de-interleaved (module docstring), in ``x``'s type."""
    a, b = x.float().unflatten(-1, (-1, 2)).unbind(-1)
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1).to(x.dtype)


def lm_logits(lm: KimiLM, h):
    """``lm_head`` of the final-normed stream, in f32: on the card the bf16
    product with an f32 output."""
    w = lm.lm_head.weight
    if h.is_cuda and h.dtype != torch.float32:
        return torch.mm(h, w.t(), out_dtype=torch.float32)
    return F.linear(h.float(), w.float())


class LatentCache:
    """The attention state of one narrated batch of ``clips`` clips of
    ``r`` sequences: ``prefix`` (layers, clips, P, 576), each clip's
    prefix of latents (the normalised latent, then the rotated key), read
    by its R sequences; ``tail`` (layers, clips * r, length, 576), each
    sequence's own latents from position P on. Beside them, what the
    experts did: ``prefix_routes`` (MoE layers - 1, clips * P, k) the
    prefill's expert sets, ``routes`` (MoE layers, clips * r, k) the
    latest decode step's sets, and ``ends`` (length, MoE layers, G) each
    decode step's groups' ends. All preallocated, so a step's shapes never
    change."""

    def __init__(self, cfg: KimiLMConfig, clips: int, r: int, prefix: int, length: int, *, dtype, device):
        layers, d, k, n_moe = cfg.num_hidden_layers, cfg.latent_dim, cfg.num_experts_per_tok, cfg.moe_layers
        self.r, self.kv_lora = r, cfg.kv_lora_rank
        self.prefix = torch.empty(layers, clips, prefix, d, dtype=dtype, device=device)
        self.tail = torch.empty(layers, clips * r, length, d, dtype=dtype, device=device)
        # the prefill runs no MoE in the last layer (its latents are all it needs there)
        self.prefix_routes = torch.empty(max(n_moe - 1, 0), clips * prefix, k, dtype=torch.long, device=device)
        self.routes = torch.empty(n_moe, clips * r, k, dtype=torch.long, device=device)
        self.ends = torch.zeros(length, n_moe, cfg.groups, dtype=torch.int32, device=device)
        self.cos, self.sin = rope_table(cfg, prefix + length, device)

    def write_prefix(self, layer: int, c, k_pe):
        """A clip-major (clips * P, ...) prefill's latents and rotated keys."""
        out = self.prefix[layer].view(-1, self.prefix.shape[-1])
        out[:, :self.kv_lora] = c
        out[:, self.kv_lora:] = k_pe

    def write_tail(self, layer: int, pos: int, c, k_pe):
        """One step's (N, ...) latents and rotated keys at tail slot ``pos``."""
        self.tail[layer, :, pos, :self.kv_lora] = c
        self.tail[layer, :, pos, self.kv_lora:] = k_pe


def route(gate: Gate, cfg: KimiLMConfig, h):
    """(T, H) rows -> (expert ids (T, k), weights (T, k) f32): selected by
    ``sigmoid + bias``, weighted by the sigmoid, normalised, scaled."""
    scores = F.linear(h.float(), gate.weight.float()).sigmoid()
    idx = torch.topk(scores + gate.e_score_correction_bias.float(), cfg.num_experts_per_tok, dim=-1).indices
    w = scores.gather(1, idx)
    if cfg.norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, w * cfg.routed_scaling_factor


def with_shared(cfg: KimiLMConfig, idx, w):
    """Each token's groups and weights with the shared groups appended at weight 1."""
    t, s = idx.shape[0], cfg.n_shared_experts
    shared = torch.arange(cfg.n_routed_experts, cfg.groups, device=idx.device).expand(t, s)
    return torch.cat([idx, shared], dim=1), torch.cat([w, w.new_ones(t, s)], dim=1)


def grouped_mm(x, w, ends):
    """Rows ``x`` (R, K) sorted by group, group g's rows ending at
    ``ends[g]``, times each group's (N, K) weight of ``w`` (G, N, K) -> (R, N)."""
    return torch._grouped_mm(x, w.transpose(-2, -1), offs=ends)


def moe(mlp: MoE, cfg: KimiLMConfig, h, routes=None, ends=None):
    """The expert layer of (T, H) rows (module docstring); ``routes`` (T, k)
    and ``ends`` (G,), where given, receive the expert sets and the groups'
    ends."""
    with span("hh.narrate.moe", h.device):
        idx, w = route(mlp.gate, cfg, h)
        if routes is not None:
            routes.copy_(idx)
        ids, wts = with_shared(cfg, idx, w)
        t, g = ids.shape
        key = torch.uint8 if cfg.groups <= 256 else torch.int32  # the sort's passes: one a key byte
        sorted_ids, order = torch.sort(ids.reshape(-1).to(key), stable=True)
        groups = torch.arange(cfg.groups, device=h.device, dtype=key)
        ends = torch.searchsorted(sorted_ids, groups, right=True, out_int32=True, out=ends)
        x = h[order // g]
        gate_up = grouped_mm(x, mlp.experts.gate_up_proj, ends)
        gate, up = gate_up.chunk(2, dim=-1)
        act = F.silu(gate) * up * wts.reshape(-1)[order, None].to(h.dtype)  # each row weighted before down_proj
        y = grouped_mm(act, mlp.experts.down_proj, ends)
        return torch.empty_like(y).index_copy_(0, order, y).view(t, g, -1).sum(dim=1)


def _dense(mlp: DenseMLP, h):
    gate, up = F.linear(h, mlp.gate_up_proj.weight).chunk(2, dim=-1)
    return F.linear(F.silu(gate) * up, mlp.down_proj.weight)


def _latent(attn: MLA, cfg: KimiLMConfig, h, cos, sin):
    """(T, H) rows -> (normalised latents (T, 512), rotated keys (T, 64))."""
    ckv = F.linear(h, attn.kv_a_proj_with_mqa.weight)
    c = _rms(attn.kv_a_layernorm, ckv[:, :cfg.kv_lora_rank], cfg.kv_norm_eps)
    return c, apply_rope(ckv[:, cfg.kv_lora_rank:], cos, sin)


def _mla_prefill(attn: MLA, cfg: KimiLMConfig, h, b: int, p: int, cache: LatentCache, i: int, last: bool):
    """Explicit MLA of ``b`` clip-major prefixes of ``p`` positions
    ((b * p, H) rows), their latents written into ``cache.prefix[i]``."""
    nh, nope, rope, vd = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    cos, sin = cache.cos[:p].repeat(b, 1), cache.sin[:p].repeat(b, 1)
    c, k_pe = _latent(attn, cfg, h, cos, sin)
    cache.write_prefix(i, c, k_pe)
    if last:
        return None
    q = F.linear(h, attn.q_proj.weight).view(b * p, nh, cfg.q_head_dim)
    q = torch.cat([q[..., :nope], apply_rope(q[..., nope:], cos[:, None], sin[:, None])], dim=-1)
    k_nope, v = F.linear(c, attn.kv_b_proj.weight).view(b * p, nh, nope + vd).split([nope, vd], dim=-1)
    k = torch.cat([k_nope, k_pe[:, None].expand(-1, nh, rope)], dim=-1)
    v = F.pad(v, (0, cfg.q_head_dim - vd))  # one head width for q, k and v: SDPA's fused kernels take it

    def heads(z):
        return z.view(b, p, nh, -1).transpose(1, 2)

    out = F.scaled_dot_product_attention(heads(q), heads(k), heads(v), is_causal=True, scale=cfg.q_head_dim**-0.5)
    return F.linear(out[..., :vd].transpose(1, 2).reshape(b * p, nh * vd), attn.o_proj.weight)


def experts_hit(cfg: KimiLMConfig, ends) -> int:
    """The routed experts that steps hit, each MoE layer's distinct ones a
    step, from their groups' ends (..., G): a read of the device."""
    rows = torch.diff(ends, dim=-1, prepend=torch.zeros_like(ends[..., :1]))
    return int((rows[..., :cfg.n_routed_experts] > 0).sum())


def prefill(lm: KimiLM, cfg: KimiLMConfig, embeds, cache: LatentCache):
    """Each clip's (B, P, H) prefix through the layers: every layer's
    latents into ``cache.prefix``, the expert sets into
    ``cache.prefix_routes``."""
    b, p, _ = embeds.shape
    x = embeds.reshape(b * p, -1)
    layers = lm.model.layers
    for i, layer in enumerate(layers):
        last = i == len(layers) - 1
        out = _mla_prefill(layer.self_attn, cfg, _rms(layer.input_layernorm, x, cfg.rms_norm_eps), b, p, cache, i,
                           last)
        if last:
            break
        x = x + out
        h = _rms(layer.post_attention_layernorm, x, cfg.rms_norm_eps)
        if i < cfg.first_k_dense_replace:
            x = x + _dense(layer.mlp, h)
        else:
            x = x + moe(layer.mlp, cfg, h, routes=cache.prefix_routes[i - cfg.first_k_dense_replace])
            count("hh.narrate.expert_rows", b * p * cfg.num_experts_per_tok)


def latent_attend(q, prefix, tail, r: int, scale: float, dv: int):
    """(N, heads, 576) latent query rows over the clip's prefix (clips, P,
    576) and each sequence's tail (N, t, 576) -> (N, heads, 512)."""
    return latent_attention.attend(q, prefix, tail, r, scale, dv)


def _mla_decode(attn: MLA, cfg: KimiLMConfig, h, cache: LatentCache, i: int, pos: int, cos, sin):
    """Absorbed MLA of one step's (N, H) rows at tail slot ``pos``."""
    n, nh, nope, vd = h.shape[0], cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    c, k_pe = _latent(attn, cfg, h, cos, sin)
    cache.write_tail(i, pos, c, k_pe)
    q = F.linear(h, attn.q_proj.weight).view(n, nh, cfg.q_head_dim)
    w_kv = attn.kv_b_proj.weight.view(nh, nope + vd, cfg.kv_lora_rank)
    q_lat = torch.bmm(q[..., :nope].transpose(0, 1), w_kv[:, :nope])  # (heads, N, 512)
    q = torch.cat([q_lat.transpose(0, 1), apply_rope(q[..., nope:], cos, sin)], dim=-1)
    out = latent_attend(q, cache.prefix[i], cache.tail[i, :, :pos + 1], cache.r, cfg.q_head_dim**-0.5,
                        cfg.kv_lora_rank)
    out = torch.bmm(out.transpose(0, 1), w_kv[:, nope:].transpose(1, 2))  # (heads, N, v)
    return F.linear(out.transpose(0, 1).reshape(n, nh * vd), attn.o_proj.weight)


def decode_step(lm: KimiLM, cfg: KimiLMConfig, cache: LatentCache, ids, pos: int):
    """One token of every sequence: (N,) ids at tail slot ``pos`` (position
    P + pos) -> f32 logits (N, V); its latents written into the tail, its
    expert sets into ``cache.routes`` and its groups' ends into
    ``cache.ends[pos]``."""
    p = cache.prefix.shape[2] + pos
    cos, sin = cache.cos[p], cache.sin[p]
    x = lm.model.embed_tokens.weight[ids]
    for i, layer in enumerate(lm.model.layers):
        x = x + _mla_decode(layer.self_attn, cfg, _rms(layer.input_layernorm, x, cfg.rms_norm_eps), cache, i, pos,
                            cos, sin)
        h = _rms(layer.post_attention_layernorm, x, cfg.rms_norm_eps)
        if i < cfg.first_k_dense_replace:
            x = x + _dense(layer.mlp, h)
        else:
            j = i - cfg.first_k_dense_replace
            x = x + moe(layer.mlp, cfg, h, routes=cache.routes[j], ends=cache.ends[pos, j])
    return lm_logits(lm, _rms(lm.model.norm, x, cfg.rms_norm_eps))
