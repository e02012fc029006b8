"""LaViLa's narrator in plain float32 (``VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL``
of github.com/facebookresearch/LaViLa, ``lavila/models/models.py``,
``gpt2_gated.py`` and ``coca.py``), for the comparison that decides
``correct``. No cache, no kernel, no batching trick: the latents are
repeated for every sequence and every forward runs over whole sequences.

- ``tower``: ``model.timesformer`` (the frozen-in-time TimeSformer) at the
  configuration's ``img_size``: every token after the final LayerNorm.
- ``pool``: coca's ``CrossAttention(norm_context=True)``: ``q = Wq LN(Q)``
  of the learned queries split into heads, one key/value head ``Wkv
  LN_c(ctx)`` shared by all of them, ``softmax(q k^T / sqrt(dh) - max) v``,
  ``Wo``; no bias, no residual; then ``img_attn_pool_norm``. coca's
  LayerNorms: weight ``gamma``, bias buffer ``beta``, eps 1e-5.
- ``lm_logits``: GPT-2 (HF ``GPT2LMHeadModel``, ``Conv1D`` weights (in,
  out)) with LaViLa's gated cross-attention in every
  ``cross_attn_every``-th block: ``x += attn(ln_1 x)`` causal; ``x +=
  tanh(g) xattn(ln_cross_attn x, latents)`` (``q_attn`` on the stream,
  ``c_attn`` -> k | v on the latents, no mask); ``x += mlp(ln_2 x)`` with
  ``gelu_new`` written out; ``ln_f``; ``lm_head`` tied to ``wte``.
  Teacher-forced: the logits of every position.
- ``nucleus``: temperature, then top-p in the descending form (a token is
  kept when the mass of the tokens ranked above it is under ``top_p``).
- ``generate``: the sampler of LaViLa's ``generate`` on the reference:
  each step a whole forward over the sequence so far, for the controls.

``mm`` is the matrix product of a part's linear layers (``lowp.fp8_linear``
for the controls); ``low``, a type for the language model's LayerNorm
statistics and outputs, attention softmax and logits (bf16 for a control),
None for float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .model import timesformer

LM = "text_decoder.transformer"


def _coca_ln(w, name, x):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.gamma"], w[f"{name}.beta"], 1e-5)


def _ln(w, name, x, eps, low=None):
    if low is None:
        return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"], w[f"{name}.bias"], eps)
    x = x.to(low)
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + eps) * w[f"{name}.weight"].to(low) + w[f"{name}.bias"].to(low)).float()


def tower(w: dict, cfg: dict, video: torch.Tensor, mm=F.linear) -> torch.Tensor:
    """Normalised clips (B, T, H, W, C) -> (B, 1 + T*N, width)."""
    return timesformer(w, cfg["visual"], video, mm=mm)


def pool(w: dict, cfg: dict, tokens: torch.Tensor, mm=F.linear) -> torch.Tensor:
    """(B, S, width) tower tokens -> (B, num_queries, n_embd) latents."""
    heads, dh = cfg["pool"]["heads"], cfg["pool"]["dim_head"]
    q = mm(_coca_ln(w, "img_attn_pool.norm", w["img_queries"]), w["img_attn_pool.to_q.weight"], None)
    q = q.reshape(-1, heads, dh).transpose(0, 1) * dh**-0.5  # (H, M, dh)
    ctx = _coca_ln(w, "img_attn_pool.context_norm", tokens)
    k, v = mm(ctx, w["img_attn_pool.to_kv.weight"], None).chunk(2, dim=-1)  # (B, S, dh) each
    sim = torch.einsum("hmd,bsd->bhms", q, k)
    attn = (sim - sim.amax(dim=-1, keepdim=True)).softmax(dim=-1)
    out = torch.einsum("bhms,bsd->bmhd", attn, v).flatten(2)
    return _coca_ln(w, "img_attn_pool_norm", mm(out, w["img_attn_pool.to_out.weight"], None))


def _gelu_new(x):
    return 0.5 * x * (1.0 + torch.tanh((2.0 / torch.pi) ** 0.5 * (x + 0.044715 * x**3)))


def _conv1d(w, name, x, mm):
    return mm(x, w[f"{name}.weight"].t(), w[f"{name}.bias"])


def _heads(x, heads):
    n, s, d = x.shape
    return x.reshape(n, s, heads, d // heads).transpose(1, 2)


def _attend(q, k, v, mask=None, low=None):
    scores = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    if mask is not None:
        scores = scores + mask
    if low is not None:
        scores = scores.to(low)
        e = (scores - scores.amax(dim=-1, keepdim=True)).exp()
        return (e / e.sum(dim=-1, keepdim=True)).float() @ v
    return torch.softmax(scores, dim=-1) @ v


def _merge(x):
    n, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(n, s, h * dh)


def lm_logits(w: dict, cfg: dict, ids: torch.Tensor, latents: torch.Tensor, mm=F.linear, low=None) -> torch.Tensor:
    """ids (N, L), latents (N, M, n_embd), one set a sequence -> logits (N, L, V)."""
    lm = cfg["lm"]
    n, length = ids.shape
    heads, d, eps, every = lm["n_head"], lm["n_embd"], lm["layer_norm_epsilon"], lm["cross_attn_every"]
    x = w[f"{LM}.wte.weight"][ids] + w[f"{LM}.wpe.weight"][:length]
    causal = torch.full((length, length), float("-inf"), device=ids.device).triu(1)
    for i in range(lm["n_layer"]):
        blk = f"{LM}.h.{i}"
        q, k, v = (_heads(z, heads) for z in _conv1d(w, f"{blk}.attn.c_attn", _ln(w, f"{blk}.ln_1", x, eps, low), mm)
                   .split(d, dim=-1))
        x = x + _conv1d(w, f"{blk}.attn.c_proj", _merge(_attend(q, k, v, causal, low)), mm)
        if every and i % every == 0:
            q = _heads(_conv1d(w, f"{blk}.crossattention.q_attn", _ln(w, f"{blk}.ln_cross_attn", x, eps, low), mm), heads)
            k, v = (_heads(z, heads) for z in _conv1d(w, f"{blk}.crossattention.c_attn", latents, mm).split(d, -1))
            out = _conv1d(w, f"{blk}.crossattention.c_proj", _merge(_attend(q, k, v, low=low)), mm)
            x = x + torch.tanh(w[f"{blk}.cross_attn_gate"]) * out
        h = _ln(w, f"{blk}.ln_2", x, eps, low)
        x = x + _conv1d(w, f"{blk}.mlp.c_proj", _gelu_new(_conv1d(w, f"{blk}.mlp.c_fc", h, mm)), mm)
    logits = mm(_ln(w, f"{LM}.ln_f", x, eps, low), w[f"{LM}.wte.weight"], None)
    return logits if low is None else logits.to(low).float()


def nucleus(logits: torch.Tensor, temperature: float, top_p: float) -> torch.Tensor:
    """(N, V) logits -> (N, V) bool, True outside the top-``top_p`` nucleus
    of the logits over ``temperature`` (descending form)."""
    probs, order = torch.sort((logits / temperature).softmax(dim=-1), dim=-1, descending=True)
    outside = probs.cumsum(dim=-1) - probs >= top_p
    return torch.empty_like(outside).scatter_(1, order, outside)


def generate(w: dict, cfg: dict, latents: torch.Tensor, generator, mm=F.linear, low=None):
    """One clip's (1, M, n_embd) latents -> (ids (R, L), logits (L - 1, R, V))
    sampled as LaViLa's ``generate`` does, each step a whole forward."""
    g = cfg["generation"]
    r, length = g["num_return_sequences"], g["max_text_length"]
    ids = torch.full((r, 1), g["bos_token_id"], dtype=torch.long, device=latents.device)
    lat = latents.expand(r, -1, -1)
    steps = []
    for _ in range(length - 1):
        logits = lm_logits(w, cfg, ids, lat, mm, low)[:, -1]
        scores = (logits / g["temperature"]).masked_fill(nucleus(logits, g["temperature"], g["top_p"]),
                                                         float("-inf"))
        nxt = torch.multinomial(scores.softmax(dim=-1), 1, generator=generator)
        ids = torch.cat([ids, nxt], dim=1)
        steps.append(logits)
    return ids, torch.stack(steps)
