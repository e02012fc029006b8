"""LaViLa's narrator: a TimeSformer-L/14 at 336 px under GPT-2 XL with gated
cross-attention (``VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL`` of
``lavila/models/models.py``, ``VCLM_HF``), and its sampler.

LaViLa densely re-narrates Ego4D clips with it, ten sampled narrations a
clip; that text trained the dual encoder the rest of this package freezes.

- Visual tower: the package's TimeSformer (``spacetime_forward``, K1/K2 on
  the card) at ``img_size`` 336, patch 14, width 1024, depth 24, 16 heads,
  MLP 4096 with QuickGELU, 4 frames (577 rows of ``pos_embed``); every
  token after the final LayerNorm, (B, 1 + 4 * 576, 1024), CLS first.
- Attention pooler (``img_attn_pool``, coca's ``CrossAttention(dim=1600,
  context_dim=1024, dim_head=64, heads=25, norm_context=True)``):
  ``q = Wq LN(Q)`` of 256 learned queries, ``k, v = split(Wkv LN_c(ctx))``
  with one key/value head of 64 shared by the 25 query heads
  (multi-query), ``out = Wo softmax(q k^T / 8) v``, all three without
  bias and with no residual; then ``img_attn_pool_norm``. Every LayerNorm
  here is coca's: a weight, a zero bias buffer, eps 1e-5.
- Language model: ``models/gpt2.py`` (GPT-2 XL with a gated
  cross-attention over the 256 latents in every second block).
- Generation (LaViLa's ``generate`` with ``demo_narrator.py``'s settings):
  BOS = EOS = 50256, ``num_return_sequences`` R sequences a clip,
  ``max_text_length`` positions (so ``max_text_length - 1`` sampled
  tokens), temperature then top-p (``ops/sampling.py``), a draw from the
  caller's generator.

``NarratorModel.narrate`` runs the tower and the pooler, makes each cross
layer's keys and values once per clip (``gpt2.prefill_cross``), then
decodes every sequence of the batch together through a preallocated
``gpt2.NarrateCache``, kept from batch to batch with its
``step_graphs.Decoder`` (on the card the first batch of a shape decodes eagerly and records each
step into a CUDA graph; later batches replay them). Departures from LaViLa's ``generate``, none in what
a sequence says: the latents and cross keys are held once per clip, not
repeated per sequence; a sequence that has drawn EOS is padded with EOS
(LaViLa keeps sampling and cuts its text at the first EOS); and every
batch runs all ``max_text_length - 1`` steps, since stopping once all
sequences are done would read the device each step. With seeded random
weights EOS is practically never drawn, so the steps are the same.

Spans (``utils/profiling.py``): ``hh.narrate.tower`` (the preprocess and
the tower), ``hh.narrate.prefill`` (the pooler and the cross keys),
``hh.narrate.decode`` (a step's 48 blocks and ``lm_head``) with
``hh.narrate.decode.attn`` inside it (each attention call), and
``hh.narrate.sample``; counters of decode steps, tokens drawn and the two
caches' bytes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import decode_attention
from ..ops.preprocess import resize_normalize
from ..ops.sampling import sample_next
from ..utils.profiling import active, count, span
from . import gpt2, kimi_lm
from .gpt2 import GatedGPT2, GPT2Config, NarrateCache, prefill_cross
from .kimi_lm import KimiLM, KimiLMConfig, kimi_lm_tiny_config
from .spacetime_vit import SpaceTimeConfig, SpaceTimeViT, spacetime_forward
from .step_graphs import Decoder

__all__ = ["KimiNarratorConfig", "KimiNarratorModel", "NarratorConfig", "NarratorModel", "attention_pool",
           "encode_video", "kimi_tiny_config", "narrator_tiny_config", "prefill_prefix", "project_visual",
           "sample_steps"]


def _visual_336() -> SpaceTimeConfig:
    return SpaceTimeConfig(img_size=336, patch_size=14, width=1024, depth=24, heads=16, mlp_ratio=4, num_frames=4,
                           ln_eps=1e-6)


@dataclass(frozen=True)
class NarratorConfig:
    """``VCLM_OPENAI_TIMESFORMER_LARGE_336PX_GPT2_XL`` with ``demo_narrator.py``'s
    generation settings."""

    visual: SpaceTimeConfig = field(default_factory=_visual_336)
    lm: GPT2Config = field(default_factory=GPT2Config)
    num_img_queries: int = 256
    pool_heads: int = 25
    pool_dim_head: int = 64
    num_return_sequences: int = 10
    max_text_length: int = 77
    temperature: float = 0.7
    top_p: float = 0.95
    bos_token_id: int = 50256
    eos_token_id: int = 50256


def narrator_tiny_config(**overrides) -> NarratorConfig:
    """A miniature for tests (no released weights): a 2-block tower of width
    32 on 28 px clips of 2 frames, 8 latents, a 4-block GPT-2 of width 64
    with 4 heads and a 97-word vocabulary, 3 sequences of 6 positions."""
    base = dict(
        visual=SpaceTimeConfig(img_size=28, patch_size=14, width=32, depth=2, heads=2, mlp_ratio=4, num_frames=2),
        lm=GPT2Config(vocab_size=97, n_positions=16, n_embd=64, n_layer=4, n_head=4, n_inner=256),
        num_img_queries=8, pool_heads=4, pool_dim_head=16, num_return_sequences=3, max_text_length=6,
        bos_token_id=96, eos_token_id=96,
    )
    return NarratorConfig(**{**base, **overrides})


class CocaLayerNorm(nn.Module):
    """coca's LayerNorm: a weight ``gamma`` and a zero bias buffer ``beta``."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim, device=device))
        self.register_buffer("beta", torch.zeros(dim, device=device))


def _coca_ln(p: CocaLayerNorm, x, eps: float = 1e-5):
    """Statistics in f32; the result in ``x``'s type."""
    return F.layer_norm(x.float(), x.shape[-1:], p.gamma.float(), p.beta.float(), eps).to(x.dtype)


class AttentionPool(nn.Module):
    """coca's ``CrossAttention`` with ``norm_context=True`` (module docstring)."""

    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int, *, generator=None, device=None):
        super().__init__()
        self.norm = CocaLayerNorm(dim, device)
        self.context_norm = CocaLayerNorm(context_dim, device)
        self.to_q = nn.Linear(dim, heads * dim_head, bias=False, device=device)
        self.to_kv = nn.Linear(context_dim, 2 * dim_head, bias=False, device=device)
        self.to_out = nn.Linear(heads * dim_head, dim, bias=False, device=device)
        if self.to_q.weight.device.type != "meta":
            with torch.no_grad():
                for lin in (self.to_q, self.to_kv, self.to_out):
                    lin.weight.normal_(0.0, lin.in_features**-0.5, generator=generator)


class NarratorModel(nn.Module):
    """Parameters of the narrator under ``VCLM_HF``'s names (``visual`` in
    the package's TimeSformer layout, ``img_queries``, ``img_attn_pool``,
    ``img_attn_pool_norm``, ``text_decoder``), and its sampler
    (``narrate``). Random weights from ``generator``; ``.to(dtype)`` casts
    every weight, so a bf16 model holds no f32 copy."""

    def __init__(self, cfg: NarratorConfig, *, generator=None, device=None):
        super().__init__()
        kw = {"generator": generator, "device": device}
        self.cfg = cfg
        d = cfg.lm.n_embd
        self.visual = SpaceTimeViT(cfg.visual, **kw)
        self.img_queries = nn.Parameter(torch.empty(cfg.num_img_queries, d, device=device))
        if self.img_queries.device.type != "meta":
            with torch.no_grad():
                self.img_queries.normal_(0.0, 1.0, generator=generator)
        self.img_attn_pool = AttentionPool(d, cfg.visual.width, cfg.pool_heads, cfg.pool_dim_head, **kw)
        self.img_attn_pool_norm = CocaLayerNorm(d, device)
        self.text_decoder = GatedGPT2(cfg.lm, **kw)
        self._decoder = None  # the last batch shape's cache and decode graphs

    def decoder(self, clips: int, latents: int, device) -> Decoder:
        """The ``Decoder`` of ``gpt2.decode_step`` for batches of ``clips``
        clips: the last one's when it has that shape, else a new one (the
        old cache freed first). Its graphs keep how many K8 launches each
        holds."""
        cfg, lm = self.cfg, self.text_decoder
        shape = (clips, cfg.num_return_sequences, cfg.max_text_length, latents)
        if self._decoder is None or not self._decoder.matches(lm, shape, device):
            self._decoder = None
            cache = NarrateCache(cfg.lm, *shape, dtype=self.dtype, device=device)
            self._decoder = Decoder(lm, cache, lambda ids, pos: gpt2.decode_step(lm, cfg.lm, cache, ids, pos),
                                    shape=shape, rows=cache.kv.shape[2], vocab=cfg.lm.vocab_size,
                                    device=cache.kv.device, launches=decode_attention.launches)
        return self._decoder

    @property
    def dtype(self):
        return self.text_decoder.transformer.wte.weight.dtype

    def narrate(self, video_u8, generator=None):
        """(B, T, H, W, C) uint8 clips on the model's device -> token ids
        (B, R, ``max_text_length``), BOS first, drawn from ``generator``."""
        cfg = self.cfg
        dev = video_u8.device
        b = video_u8.shape[0]
        with torch.inference_mode():
            with span("hh.narrate.tower", dev):
                tokens = encode_video(self, resize_normalize(video_u8, cfg.visual.img_size))
            with span("hh.narrate.prefill", dev):
                latents = attention_pool(self, tokens)
                dec = self.decoder(b, latents.shape[1], dev)
                prefill_cross(self.text_decoder, cfg.lm, latents, dec.cache)
            self_bytes, cross_bytes = dec.cache.nbytes
            count("hh.narrate.self_cache_bytes", self_bytes)
            count("hh.narrate.cross_cache_bytes", cross_bytes)
            replayed = bool(dec.graphs)
            ids = sample_steps(dec, cfg, b, generator, dev)
            if replayed:  # the eager steps' calls count themselves
                count("hh.narrate.decode_attn_kernel_calls", sum(dec.kernel_calls))
            return ids


def sample_steps(dec, cfg, clips: int, generator, dev):
    """The decode loop both narrators share: every sequence starts at BOS;
    step ``pos`` decodes the tokens at ``pos`` (``dec.step``, a graph's
    replay once recorded) and draws those at ``pos + 1`` (``sample_next``);
    a sequence that has drawn EOS is padded with it. Records the steps'
    graphs after the shape's first, eager, batch. -> (clips, R, length) ids."""
    r, length, eos = cfg.num_return_sequences, cfg.max_text_length, cfg.eos_token_id
    ids = torch.full((clips * r, length), eos, dtype=torch.long, device=dev)
    ids[:, 0] = cfg.bos_token_id
    finished = torch.zeros(clips * r, dtype=torch.bool, device=dev)
    tok = ids[:, 0]
    for pos in range(length - 1):
        with span("hh.narrate.decode", dev):
            logits = dec.step(tok, pos)
        with span("hh.narrate.sample", dev):
            tok = sample_next(logits, cfg.temperature, cfg.top_p, generator).masked_fill_(finished, eos)
            finished |= tok == eos
            ids[:, pos + 1] = tok
        count("hh.narrate.decode_steps")
        count("hh.narrate.tokens", clips * r)
    if dec.can_capture():  # this batch was the shape's warm-up
        dec.capture(length - 1)
    return ids.view(clips, r, length)


def encode_video(model: NarratorModel, video):
    """Normalised clips (B, T, H, W, C) -> every token of the tower after its
    final LayerNorm, (B, 1 + T * N, width) f32, CLS first."""
    return spacetime_forward(model.visual, model.cfg.visual, video, dtype=model.dtype)[1]


def attention_pool(model: NarratorModel, tokens):
    """(B, S, width) tower tokens -> (B, num_img_queries, n_embd) latents in
    the model's type: the multi-query pooler, then ``img_attn_pool_norm``.
    The 25 heads share one key and value, so they attend as 25 * 256 query
    rows of a single head."""
    cfg, p, dt = model.cfg, model.img_attn_pool, model.dtype
    b, m, hd = tokens.shape[0], cfg.num_img_queries, cfg.pool_dim_head
    ctx = _coca_ln(p.context_norm, tokens).to(dt)
    q = F.linear(_coca_ln(p.norm, model.img_queries.to(dt)), p.to_q.weight.to(dt))  # (M, H * dh)
    q = q.view(m, cfg.pool_heads, hd).transpose(0, 1).reshape(1, 1, cfg.pool_heads * m, hd)
    k, v = F.linear(ctx, p.to_kv.weight.to(dt)).unsqueeze(1).chunk(2, dim=-1)  # (B, 1, S, dh) each
    out = F.scaled_dot_product_attention(q.expand(b, 1, -1, -1).contiguous(), k, v)
    out = out.view(b, cfg.pool_heads, m, hd).transpose(1, 2).reshape(b, m, -1)
    return _coca_ln(model.img_attn_pool_norm, F.linear(out, p.to_out.weight.to(dt)))


# ---------------------------------------------------------------- Kimi-VL


@dataclass(frozen=True)
class KimiNarratorConfig:
    """Kimi-VL-A3B's language model as a narrator: the package's
    TimeSformer-L/14 at 336 px over 4 frames in place of MoonViT, Kimi-VL's
    projector, the language model (``models/kimi_lm.py``), and the GPT-2
    narrator's generation settings. The prefix of a clip is its
    ``visual_tokens`` then ``prompt_len`` prompt ids."""

    visual: SpaceTimeConfig = field(default_factory=_visual_336)
    lm: KimiLMConfig = field(default_factory=KimiLMConfig)
    merge: int = 2  # the projector's spatial merge: merge x merge patches a visual token
    projector_ln_eps: float = 1e-5
    prompt_len: int = 24
    num_return_sequences: int = 10
    max_text_length: int = 77
    temperature: float = 0.7
    top_p: float = 0.95
    bos_token_id: int = 163584
    eos_token_id: int = 163585

    @property
    def visual_tokens(self) -> int:
        return self.visual.num_frames * self.visual.patches_per_frame // self.merge**2

    @property
    def prefix_len(self) -> int:
        return self.visual_tokens + self.prompt_len


def kimi_tiny_config(**overrides) -> KimiNarratorConfig:
    """A miniature for tests: a 2-block tower of width 32 on 56 px clips of
    2 frames (16 patches a frame, 8 visual tokens), ``kimi_lm_tiny_config``,
    4 prompt ids, 3 sequences of 6 positions."""
    base = dict(
        visual=SpaceTimeConfig(img_size=56, patch_size=14, width=32, depth=2, heads=2, mlp_ratio=4, num_frames=2),
        lm=kimi_lm_tiny_config(), prompt_len=4, num_return_sequences=3, max_text_length=6, bos_token_id=510,
        eos_token_id=511,
    )
    return KimiNarratorConfig(**{**base, **overrides})


class Projector(nn.Module):
    """Kimi-VL's ``multi_modal_projector``: ``pre_norm`` (LayerNorm of a
    patch), then ``linear_1`` (merge^2 C -> merge^2 C), GELU and ``linear_2``
    (-> hidden) over each merged group of patches."""

    def __init__(self, cfg: KimiNarratorConfig, *, generator=None, device=None):
        super().__init__()
        c, wide = cfg.visual.width, cfg.visual.width * cfg.merge**2
        self.pre_norm = nn.LayerNorm(c, eps=cfg.projector_ln_eps, device=device)
        self.linear_1 = nn.Linear(wide, wide, device=device)
        self.linear_2 = nn.Linear(wide, cfg.lm.hidden_size, device=device)
        if self.linear_1.weight.device.type != "meta":
            with torch.no_grad():
                for lin in (self.linear_1, self.linear_2):
                    lin.weight.normal_(0.0, lin.in_features**-0.5, generator=generator)
                    lin.bias.zero_()


class KimiNarratorModel(nn.Module):
    """Parameters under Kimi-VL's names (``visual`` in the package's
    TimeSformer layout, ``multi_modal_projector``, ``language_model``) and
    the sampler (``narrate``). ``prompt_ids`` (a buffer, not saved) are the
    prompt each clip's prefix ends with, seeded from ``generator``.
    ``.to(dtype)`` casts every weight."""

    def __init__(self, cfg: KimiNarratorConfig, *, generator=None, device=None):
        super().__init__()
        kw = {"generator": generator, "device": device}
        self.cfg = cfg
        self.visual = SpaceTimeViT(cfg.visual, **kw)
        self.multi_modal_projector = Projector(cfg, **kw)
        self.language_model = KimiLM(cfg.lm, **kw)
        prompt = torch.empty(cfg.prompt_len, dtype=torch.long, device=device)
        if prompt.device.type != "meta":
            prompt = torch.randint(0, cfg.lm.vocab_size, (cfg.prompt_len,), generator=generator, device=device)
        self.register_buffer("prompt_ids", prompt, persistent=False)
        self._decoder = None

    @property
    def dtype(self):
        return self.language_model.model.embed_tokens.weight.dtype

    def decoder(self, clips: int, device) -> Decoder:
        """The ``Decoder`` of ``kimi_lm.decode_step`` for batches of ``clips``
        clips: the last one's when it has that shape, else a new one (the
        old cache freed first)."""
        cfg, lm = self.cfg, self.language_model
        shape = (clips, cfg.num_return_sequences, cfg.prefix_len, cfg.max_text_length)
        if self._decoder is None or not self._decoder.matches(lm, shape, device):
            self._decoder = None
            cache = kimi_lm.LatentCache(cfg.lm, *shape, dtype=self.dtype, device=device)
            self._decoder = Decoder(lm, cache, lambda ids, pos: kimi_lm.decode_step(lm, cfg.lm, cache, ids, pos),
                                    shape=shape, rows=cache.tail.shape[1], vocab=cfg.lm.vocab_size,
                                    device=cache.tail.device)
        return self._decoder

    def narrate(self, video_u8, generator=None):
        """(B, T, H, W, C) uint8 clips on the model's device -> token ids
        (B, R, ``max_text_length``), BOS first, drawn from ``generator``
        after the prefix of each clip's visual tokens and ``prompt_ids``."""
        cfg = self.cfg
        dev = video_u8.device
        b = video_u8.shape[0]
        with torch.inference_mode():
            with span("hh.narrate.tower", dev):
                tokens = encode_video(self, resize_normalize(video_u8, cfg.visual.img_size))
            with span("hh.narrate.prefill", dev):
                vis = project_visual(self, tokens)
                dec = self.decoder(b, dev)
                prefill_prefix(self, vis, self.prompt_ids, dec.cache)
            ids = sample_steps(dec, cfg, b, generator, dev)
            if active():  # the decode steps' token-expert rows, and the experts they hit (a read of the device)
                lc, steps = cfg.lm, cfg.max_text_length - 1
                count("hh.narrate.expert_rows", steps * b * cfg.num_return_sequences * lc.num_experts_per_tok
                      * lc.moe_layers)
                count("hh.narrate.experts_hit", kimi_lm.experts_hit(lc, dec.cache.ends[:steps]))
            return ids


def project_visual(model: KimiNarratorModel, tokens):
    """(B, 1 + T * N, C) tower tokens -> (B, T * N / merge^2, hidden) visual
    tokens in the model's type: the CLS token dropped, each patch
    LayerNormed (f32 statistics), each frame's merge x merge neighbours
    concatenated (row-major within the group, as MoonViT's patch merger
    orders them), then ``linear_1``, GELU (erf) and ``linear_2``."""
    cfg, p, dt = model.cfg, model.multi_modal_projector, model.dtype
    b, t, m = tokens.shape[0], cfg.visual.num_frames, cfg.merge
    g = cfg.visual.img_size // cfg.visual.patch_size
    x = F.layer_norm(tokens[:, 1:].float(), (cfg.visual.width,), p.pre_norm.weight.float(), p.pre_norm.bias.float(),
                     cfg.projector_ln_eps).to(dt)
    x = x.view(b, t, g // m, m, g // m, m, -1).permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t * (g // m) ** 2, -1)
    x = F.gelu(F.linear(x, p.linear_1.weight.to(dt), p.linear_1.bias.to(dt)))
    return F.linear(x, p.linear_2.weight.to(dt), p.linear_2.bias.to(dt))


def prefill_prefix(model: KimiNarratorModel, vis, prompt, cache: kimi_lm.LatentCache):
    """Each clip's prefix, its (B, V, hidden) visual tokens then the
    ``prompt`` ids' embeddings, through the language model into ``cache``."""
    lm = model.language_model
    text = lm.model.embed_tokens.weight[prompt.to(vis.device)]
    embeds = torch.cat([vis, text.to(vis.dtype).expand(vis.shape[0], -1, -1)], dim=1)
    kimi_lm.prefill(lm, model.cfg.lm, embeds, cache)
