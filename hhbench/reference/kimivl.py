"""A plain float32 reference of Kimi-VL-A3B's language model as a video
narrator, written from its published description (moonshotai/Kimi-VL-A3B-
Instruct's ``config.json`` and DeepSeek-V3's modeling code) with plain
``torch`` operations on a mapping of weights under
``KimiNarratorModel.state_dict()``'s names. It imports nothing of the
port or of JAX. No cache, no kernel, no batching trick: every sequence
runs its whole prefix again, the attention is the unabsorbed MLA over
whole sequences, and the experts are a loop over experts.

- ``project``: Kimi-VL's projector on the tower's tokens, the CLS token
  dropped: LayerNorm of each patch, each frame's 2 x 2 neighbours
  concatenated, ``linear_1``, GELU (erf), ``linear_2``.
- ``lm_logits``: the language model's full forward over the prefix and
  the ids, the logits at the ids' positions. Layer by layer: RMSNorm; MLA
  with ``q = q_proj(h)``, the latent ``kv_a_layernorm(kv_a(h)[:512])``
  expanded by ``kv_b_proj`` into each head's ``k_nope`` and ``v``, RoPE on
  ``q_pe`` and the shared ``k_pe`` (DeepSeek-V3's form: the interleaved
  pairs de-interleaved, then ``x cos + rotate_half(x) sin``), causal scores
  over ``sqrt(192)``; RMSNorm; below ``first_k_dense_replace`` a SwiGLU MLP,
  above it the router (``sigmoid(gate(h))``, the top 6 of ``sigmoid +
  bias``, weights from the sigmoid, normalised, times 2.446), a loop over
  the 64 experts and the shared MLP of width 2 x 1408 (the stacked
  layout's groups 64 and 65 side by side); the final norm and
  ``lm_head``.

  ``force``, where given, holds the program's expert set of each (token,
  layer) (-1 where it made none): where that set lies within ``margin`` of
  the reference's own top 6 by selection score (every expert of it scores
  at least the reference's 6th less ``margin``), the reference takes it,
  so a near tie that rounding turned decides nothing; where it lies
  outside, the reference keeps its own and counts a miss
  (``stats["route_miss"]`` over ``stats["routed"]``).

``w`` is any mapping from a name to a float32 tensor with ``keys()``
(``kimivl_weights.LayerWeights`` on the card, which makes each layer's
weights as they are read); the layers are read in order, one at a time.
``mm`` and ``router`` compute parts in lower precisions for the controls
(``calibrate_kimivl.py``). A copy of ``tests/reference_kimivl.py``, whose
tower is the CPU tests' own.
"""

from __future__ import annotations


import torch
import torch.nn.functional as F

from .model import timesformer
from .narrator import nucleus  # noqa: F401  (the nucleus the comparison reads)

LM = "language_model"


def _rms(x, weight, eps):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * weight


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x * 0.5**0.5))


def _silu(x):
    return x / (1.0 + torch.exp(-x))


def _mm(x, weight):
    return x @ weight.t()


def tower(w, cfg: dict, video, mm=None):
    """Normalised clips (B, T, H, W, C) -> every token of the TimeSformer
    after its final LayerNorm, (B, 1 + T * N, C)."""
    return _timesformer({k: w[k] for k in w.keys() if k.startswith("visual.")}, cfg["visual"], video, mm)


def project(w, cfg: dict, tokens, mm=_mm):
    """(B, 1 + T * N, C) tower tokens -> (B, T * N / 4, hidden)."""
    v, pr = cfg["visual"], cfg["projector"]
    b, t, m = tokens.shape[0], v["num_frames"], pr["merge"]
    g = v["img_size"] // v["patch_size"]
    x = F.layer_norm(tokens[:, 1:], (v["width"],), w["multi_modal_projector.pre_norm.weight"],
                     w["multi_modal_projector.pre_norm.bias"], pr["ln_eps"])
    groups = []
    for f in range(t):
        grid = x[:, f * g * g:(f + 1) * g * g].reshape(b, g, g, -1)
        for i in range(0, g, m):
            for j in range(0, g, m):
                groups.append(torch.cat([grid[:, i + a, j + c] for a in range(m) for c in range(m)], dim=-1))
    x = torch.stack(groups, dim=1)
    x = _gelu(mm(x, w["multi_modal_projector.linear_1.weight"]) + w["multi_modal_projector.linear_1.bias"])
    return mm(x, w["multi_modal_projector.linear_2.weight"]) + w["multi_modal_projector.linear_2.bias"]


def _rope(x, positions, theta):
    """(..., S, d) rotary parts at ``positions`` (S,), DeepSeek-V3's form."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    freqs = positions.float()[:, None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)  # de-interleave
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * emb.cos() + half * emb.sin()


def _attention(w, pre, cfg, h, positions, mm=_mm, latents=None):
    s, t, _ = h.shape
    nh, nope, rope, vd, lora = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                                cfg["v_head_dim"], cfg["kv_lora_rank"])
    q = mm(h, w[f"{pre}.q_proj.weight"]).reshape(s, t, nh, nope + rope).transpose(1, 2)
    ckv = mm(h, w[f"{pre}.kv_a_proj_with_mqa.weight"])
    c = _rms(ckv[..., :lora], w[f"{pre}.kv_a_layernorm.weight"], cfg["kv_a_layernorm_eps"])
    kv = mm(c, w[f"{pre}.kv_b_proj.weight"]).reshape(s, t, nh, nope + vd).transpose(1, 2)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_pe = _rope(q[..., nope:], positions, cfg["rope_theta"])
    k_pe = _rope(ckv[..., lora:][:, None], positions, cfg["rope_theta"])
    if latents is not None:
        latents.append(torch.cat([c, k_pe[:, 0]], dim=-1))
    scores = (q[..., :nope] @ k_nope.transpose(-1, -2) + q_pe @ k_pe.transpose(-1, -2)) * (nope + rope) ** -0.5
    mask = torch.full((t, t), float("-inf"), device=h.device).triu(1)
    out = torch.softmax(scores + mask, dim=-1) @ v
    return mm(out.transpose(1, 2).reshape(s, t, nh * vd), w[f"{pre}.o_proj.weight"])


def _swiglu(x, gate, up, down, mm=_mm):
    return mm(_silu(mm(x, gate)) * mm(x, up), down)


def _moe(w, pre, cfg, h, force, margin, stats, mm=_mm, router=None, record=None):
    k, e, inter = cfg["num_experts_per_tok"], cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    shape = h.shape
    x = h.reshape(-1, shape[-1])
    if router is None:
        scores = torch.sigmoid(x @ w[f"{pre}.gate.weight"].t())
    else:  # a control: the router's product and sigmoid in a lower type
        scores = torch.sigmoid((x.to(router) @ w[f"{pre}.gate.weight"].to(router).t())).float()
    select = scores + w[f"{pre}.gate.e_score_correction_bias"]
    top = torch.topk(select, k, dim=-1)
    chosen = top.indices
    if force is not None:
        f = force.reshape(-1, k)
        given = (f >= 0).all(dim=-1)
        near = select.gather(1, f.clamp_min(0)).amin(dim=-1) >= top.values[:, -1] - margin
        take = given & near
        chosen = torch.where(take[:, None], f, chosen)
        stats["route_miss"] += int((given & ~near).sum())
        stats["routed"] += int(given.sum())
    if record is not None:
        record.append(chosen.reshape(*shape[:-1], k))
    weights = scores.gather(1, chosen)
    if cfg["norm_topk_prob"]:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    weights = weights * cfg["routed_scaling_factor"]
    gate_up, down = w[f"{pre}.experts.gate_up_proj"], w[f"{pre}.experts.down_proj"]
    out = torch.zeros_like(x)
    for j in range(e):
        rows, slot = (chosen == j).nonzero(as_tuple=True)
        if rows.numel():
            y = _swiglu(x[rows], gate_up[j, :inter], gate_up[j, inter:], down[j], mm)
            out.index_add_(0, rows, y * weights[rows, slot, None])
    shared = range(e, e + cfg["n_shared_experts"])  # one MLP of width n_shared x inter
    out = out + _swiglu(x, torch.cat([gate_up[j, :inter] for j in shared]),
                        torch.cat([gate_up[j, inter:] for j in shared]), torch.cat([down[j] for j in shared], dim=1),
                        mm)
    return out.reshape(shape)


def lm_logits(w, cfg: dict, prefix, ids, force=None, margin: float = 0.0, stats=None, mm=None, router=None,
              record=None, latents=None):
    """``prefix`` (S, P, hidden) embeddings (each sequence's visual tokens
    and prompt), ``ids`` (S, L) the tokens at positions P .. P + L - 1 ->
    logits (S, L, V) at those positions; ``force`` (MoE layers, S, P + L,
    k) the program's expert sets or None (module docstring); ``stats``
    receives the route counts, ``record`` (a list) each MoE layer's expert
    sets, ``latents`` (a list) each layer's (S, P + L, 576) normalised
    latents and rotated keys, what a cache of them would hold. For the controls: ``mm`` maps "lm" (attention, dense MLP,
    ``lm_head``) and "experts" to a product ``f(x, weight)`` (default
    ``x @ weight.t()``), ``router`` a type for the router's product and
    sigmoid."""
    stats = {"route_miss": 0, "routed": 0} if stats is None else stats
    mm = {"lm": _mm, "experts": _mm, **(mm or {})}
    p = prefix.shape[1]
    x = torch.cat([prefix, w[f"{LM}.model.embed_tokens.weight"][ids]], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    eps = cfg["rms_norm_eps"]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"{LM}.model.layers.{i}"
        x = x + _attention(w, f"{pre}.self_attn", cfg, _rms(x, w[f"{pre}.input_layernorm.weight"], eps), positions,
                           mm["lm"], latents)
        h = _rms(x, w[f"{pre}.post_attention_layernorm.weight"], eps)
        if i < cfg["first_k_dense_replace"]:
            gu, inter = w[f"{pre}.mlp.gate_up_proj.weight"], cfg["intermediate_size"]
            x = x + _swiglu(h, gu[:inter], gu[inter:], w[f"{pre}.mlp.down_proj.weight"], mm["lm"])
        else:
            j = i - cfg["first_k_dense_replace"]
            x = x + _moe(w, f"{pre}.mlp", cfg, h, None if force is None else force[j], margin, stats,
                         mm["experts"], router, record)
    h = _rms(x[:, p:], w[f"{LM}.model.norm.weight"], eps)
    return mm["lm"](h, w[f"{LM}.lm_head.weight"])


def prefix_embeds(w, vis, prompt):
    """(B, V, hidden) visual tokens and (n,) prompt ids -> (B, V + n, hidden)."""
    text = w[f"{LM}.model.embed_tokens.weight"][prompt]
    return torch.cat([vis, text.expand(vis.shape[0], -1, -1)], dim=1)


def _timesformer(w, visual: dict, video, mm=None):
    return timesformer(w, visual, video, mm=F.linear if mm is None else mm)
