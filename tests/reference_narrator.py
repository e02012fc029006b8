"""A plain float32 reference of LaViLa's narrator for the CPU tests: the
TimeSformer, the multi-query attention pooler and the gated GPT-2, each
written from its published description with plain ``torch`` operations on
a dict of weights under ``NarratorModel.state_dict()``'s names. No cache,
no kernel, no batching trick: the latents are repeated for every sequence,
each attention is one masked softmax over whole sequences, and the
teacher-forced forward gives the logits of every position. Imports
nothing of the port or of JAX.

- ``timesformer``: divided space-time attention as one masked attention
  over all ``1 + T*N`` tokens a pass (space: a patch sees the CLS token
  and its frame; time: the CLS token and its tube; the CLS token sees
  everything); time attention on norm3, space attention on norm1 of the
  time residual added to x, QuickGELU MLP on norm2, ``ln_pre`` eps 1e-5,
  block and final norms at the config's eps.
- ``pool``: coca's ``CrossAttention`` with ``norm_context``, then
  ``img_attn_pool_norm``.
- ``lm_logits``: GPT-2 with a ``tanh(gate)``-scaled cross-attention in
  the blocks the config names, ``gelu_new`` written out, ``lm_head`` tied.
- ``nucleus``: temperature then top-p in the descending form (a token is
  kept when the mass of the tokens above it is under ``top_p``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _ln(w, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], eps)


def _coca_ln(w, name, x):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.gamma"], w[f"{name}.beta"], 1e-5)


def _divided_mask(t: int, n: int, mode: str):
    """(S, S) additive mask of one divided pass over CLS + T*N tokens."""
    s = 1 + t * n
    frame = torch.arange(t).repeat_interleave(n)
    tube = torch.arange(n).repeat(t)
    key = frame if mode == "space" else tube
    allowed = torch.ones(s, s, dtype=torch.bool)
    allowed[1:, 1:] = key[:, None] == key[None, :]
    return torch.zeros(s, s).masked_fill(~allowed, float("-inf"))


def _attention(w, name, x, heads, mask):
    b, s, d = x.shape
    dh = d // heads
    qkv = x @ w[f"{name}.qkv.weight"].t() + w[f"{name}.qkv.bias"]
    q, k, v = (z.reshape(b, s, heads, dh).transpose(1, 2) for z in qkv.split(d, dim=-1))
    probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh) + mask, dim=-1)
    out = (probs @ v).transpose(1, 2).reshape(b, s, d)
    return out @ w[f"{name}.proj.weight"].t() + w[f"{name}.proj.bias"]


def timesformer(w, vcfg, video):
    """Normalised clips (B, T, H, W, C) -> every token after the final
    LayerNorm (B, 1 + T*N, D)."""
    b, t, h, wd, c = video.shape
    p, d = vcfg.patch_size, vcfg.width
    gh, gw = h // p, wd // p
    n = gh * gw
    patches = video.reshape(b, t, gh, p, gw, p, c).permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t * n, p * p * c)
    x = patches @ w["visual.patch_embed.weight"].t()
    pos = w["visual.pos_embed"][0]
    x = x + pos[1:].repeat(t, 1) + w["visual.temporal_embed"][0, :t].repeat_interleave(n, dim=0)
    x = torch.cat([w["visual.cls_token"].expand(b, 1, d) + pos[:1], x], dim=1)
    x = _ln(w, "visual.ln_pre", x, 1e-5)
    space, time = _divided_mask(t, n, "space"), _divided_mask(t, n, "time")
    eps = vcfg.ln_eps
    for i in range(vcfg.depth):
        blk = f"visual.blocks.{i}"
        tr = x + _attention(w, f"{blk}.timeattn", _ln(w, f"{blk}.norm3", x, eps), vcfg.heads, time)
        sr = x + _attention(w, f"{blk}.attn", _ln(w, f"{blk}.norm1", tr, eps), vcfg.heads, space)
        hid = _ln(w, f"{blk}.norm2", sr, eps) @ w[f"{blk}.mlp_fc1.weight"].t() + w[f"{blk}.mlp_fc1.bias"]
        hid = hid * torch.sigmoid(1.702 * hid)
        x = sr + hid @ w[f"{blk}.mlp_fc2.weight"].t() + w[f"{blk}.mlp_fc2.bias"]
    return _ln(w, "visual.norm", x, eps)


def pool(w, cfg, tokens):
    """(B, S, C) tower tokens -> (B, M, d) latents."""
    heads, dh = cfg.pool_heads, cfg.pool_dim_head
    q = _coca_ln(w, "img_attn_pool.norm", w["img_queries"]) @ w["img_attn_pool.to_q.weight"].t()
    q = q.reshape(-1, heads, dh).transpose(0, 1) * dh**-0.5  # (H, M, dh)
    ctx = _coca_ln(w, "img_attn_pool.context_norm", tokens)
    k, v = (ctx @ w["img_attn_pool.to_kv.weight"].t()).chunk(2, dim=-1)  # (B, S, dh): one head for all
    sim = torch.einsum("hmd,bsd->bhms", q, k)
    attn = (sim - sim.amax(dim=-1, keepdim=True)).softmax(dim=-1)
    out = torch.einsum("bhms,bsd->bmhd", attn, v).flatten(2)
    return _coca_ln(w, "img_attn_pool_norm", out @ w["img_attn_pool.to_out.weight"].t())


def _gelu_new(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def _conv1d(w, name, x):
    return x @ w[f"{name}.weight"] + w[f"{name}.bias"]


def _heads(x, heads):
    b, s, d = x.shape
    return x.reshape(b, s, heads, d // heads).transpose(1, 2)


def lm_logits(w, lm, ids, latents):
    """Teacher-forced GPT-2 with gated cross-attention: ids (N, L), latents
    (N, M, d) one set a sequence -> logits (N, L, V)."""
    n, length = ids.shape
    pre = "text_decoder.transformer"
    x = w[f"{pre}.wte.weight"][ids] + w[f"{pre}.wpe.weight"][:length]
    causal = torch.full((length, length), float("-inf")).triu(1)
    dh = lm.n_embd // lm.n_head
    eps = lm.layer_norm_epsilon
    for i in range(lm.n_layer):
        blk = f"{pre}.h.{i}"
        h = _ln(w, f"{blk}.ln_1", x, eps)
        q, k, v = (_heads(z, lm.n_head) for z in _conv1d(w, f"{blk}.attn.c_attn", h).split(lm.n_embd, dim=-1))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh) + causal, dim=-1) @ v
        x = x + _conv1d(w, f"{blk}.attn.c_proj", att.transpose(1, 2).reshape(n, length, -1))
        if lm.cross_attn_every and i % lm.cross_attn_every == 0:
            h = _ln(w, f"{blk}.ln_cross_attn", x, eps)
            q = _heads(_conv1d(w, f"{blk}.crossattention.q_attn", h), lm.n_head)
            k, v = (_heads(z, lm.n_head) for z in _conv1d(w, f"{blk}.crossattention.c_attn", latents).split(
                lm.n_embd, dim=-1))
            att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh), dim=-1) @ v
            out = _conv1d(w, f"{blk}.crossattention.c_proj", att.transpose(1, 2).reshape(n, length, -1))
            x = x + torch.tanh(w[f"{blk}.cross_attn_gate"]) * out
        h = _ln(w, f"{blk}.ln_2", x, eps)
        x = x + _conv1d(w, f"{blk}.mlp.c_proj", _gelu_new(_conv1d(w, f"{blk}.mlp.c_fc", h)))
    return _ln(w, f"{pre}.ln_f", x, eps) @ w[f"{pre}.wte.weight"].t()


def nucleus(logits, temperature: float, top_p: float):
    """(N, V) logits -> (scores over temperature, (N, V) bool True outside
    the nucleus), in the descending form."""
    scores = logits / temperature
    probs, order = torch.sort(scores.softmax(dim=-1), dim=-1, descending=True)
    before = probs.cumsum(dim=-1) - probs  # the mass of the tokens ranked above
    drop_sorted = before >= top_p
    drop = torch.empty_like(drop_sorted).scatter_(1, order, drop_sorted)
    return scores, drop
