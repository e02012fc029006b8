"""Kimi-VL-A3B's language model as a narrator (``models/kimi_lm.py``,
``models/narrator.py::KimiNarratorModel``) against the plain float32
reference (``reference_kimivl.py``) at a tiny size on the CPU: hidden 64,
4 heads, latent 32, rotary 8, 3 layers (1 dense, 2 MoE), 8 experts with 2
a token and 1 shared, 512 words.

- the projector; prefill and absorbed decoding through the latent cache
  against the reference's full forward, at every step; the expert layer
  against the reference's loop over experts (the bias in the selection
  only, the normalisation, the scale, the shared expert); sequences over
  one shared prefix against the prefix copied per sequence; ``narrate``
  end to end, the preset, ``build_narrator`` and the CLI;
- the sampler's plain version over rows of 163840 words against the
  reference's nucleus;
- ``hhbench/counts/kimivl.py::flops_per_clip`` against
  ``utils/flops.py::kimivl_flops_per_clip``;
- the benchmark cell's mix on the CPU: each planted fault of
  ``hhbench/kimivl_faults.py`` makes its comparison fail, and the program
  passes it;
- ``cuda``-marked: graph replay equal to the eager steps, the latent
  softmax kernel against its plain version, and the sampler kernel over
  640 x 163840 rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import reference_kimivl as ref
from helping_hand_for_egocentric_videos_torch.core.config import NarratorCfg
from helping_hand_for_egocentric_videos_torch.models import kimi_lm, narrator
from helping_hand_for_egocentric_videos_torch.models.narrator import (
    KimiNarratorConfig,
    KimiNarratorModel,
    kimi_tiny_config,
    project_visual,
)
from helping_hand_for_egocentric_videos_torch.ops import latent_attention, sampling

F32 = dict(rtol=1e-5, atol=1e-5)
F32_DEEP = dict(rtol=1e-4, atol=1e-4)
B = 2


def ref_cfg(cfg: KimiNarratorConfig) -> dict:
    """The reference's dict: the language model's fields at the top level
    (``kv_norm_eps`` under the reference's name), the tower's and the
    projector's groups."""
    out = dataclasses.asdict(cfg.lm)
    out["kv_a_layernorm_eps"] = out.pop("kv_norm_eps")
    v = cfg.visual
    out["visual"] = {"num_frames": v.num_frames, "img_size": v.img_size, "patch_size": v.patch_size,
                     "width": v.width}
    out["projector"] = {"merge": cfg.merge, "ln_eps": cfg.projector_ln_eps}
    return out


def randomize(model: KimiNarratorModel, seed: int = 0) -> dict:
    """Norm weights 1 + N(0, 0.1), biases N(0, 0.1), the rest as built ->
    the f32 state dict."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("norm.weight", "layernorm.weight", "ln_pre.weight", "norm1.weight", "norm2.weight",
                              "norm3.weight")):
                t.copy_(1.0 + 0.1 * torch.randn(t.shape, generator=g))
            elif name.endswith(".bias") and t.dim() == 1:
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def tiny():
    cfg = kimi_tiny_config()
    model = KimiNarratorModel(cfg, generator=torch.Generator().manual_seed(0)).eval()
    w = randomize(model)
    return cfg, model, w


def clips(cfg, seed: int = 1, b: int = B):
    g = torch.Generator().manual_seed(seed)
    v = cfg.visual
    return torch.randint(0, 256, (b, v.num_frames, v.img_size, v.img_size, 3), generator=g, dtype=torch.uint8)


def prefix_of(model, cfg, seed: int = 3, b: int = B):
    """Seeded visual tokens and prompt -> (B, P, hidden) prefix embeddings."""
    g = torch.Generator().manual_seed(seed)
    vis = torch.randn(b, cfg.visual_tokens, cfg.lm.hidden_size, generator=g)
    prompt = torch.randint(0, cfg.lm.vocab_size, (cfg.prompt_len,), generator=g)
    return ref.prefix_embeds(model.state_dict(), vis, prompt)


def decode(model, cfg, embeds, ids, r):
    """Prefill, then teacher-forced absorbed decoding -> (logits (N, L, V),
    the program's expert sets (MoE layers, N, P + L, k), -1 where none)."""
    lm, lc = model.language_model, cfg.lm
    clips_, p = embeds.shape[:2]
    n, length = ids.shape
    cache = kimi_lm.LatentCache(lc, clips_, r, p, length, dtype=torch.float32, device="cpu")
    kimi_lm.prefill(lm, lc, embeds, cache)
    k = lc.num_experts_per_tok
    sets = torch.full((lc.moe_layers, n, p + length, k), -1, dtype=torch.long)
    sets[:-1, :, :p] = cache.prefix_routes.view(lc.moe_layers - 1, clips_, p, k).repeat_interleave(r, dim=1)
    steps = []
    for pos in range(length):
        steps.append(kimi_lm.decode_step(lm, lc, cache, ids[:, pos], pos))
        sets[:, :, p + pos] = cache.routes
    return torch.stack(steps, dim=1), sets


def test_projector_matches_reference(tiny):
    cfg, model, w = tiny
    g = torch.Generator().manual_seed(3)
    tokens = torch.randn(B, 1 + cfg.visual.patches_per_frame * cfg.visual.num_frames, cfg.visual.width, generator=g)
    with torch.no_grad():
        got = project_visual(model, tokens)
    assert got.shape == (B, cfg.visual_tokens, cfg.lm.hidden_size)
    torch.testing.assert_close(got, ref.project(w, ref_cfg(cfg), tokens), **F32)


def test_cached_decoding_matches_the_full_forward_at_every_step(tiny):
    """Prefill and absorbed decoding through the latent cache give the
    reference's unabsorbed full forward over prefix + ids, with the
    reference taking the program's expert sets, all of which lie within
    rounding of its own."""
    cfg, model, w = tiny
    r, length = 3, 5
    embeds = prefix_of(model, cfg)
    g = torch.Generator().manual_seed(4)
    ids = torch.randint(0, cfg.lm.vocab_size, (B * r, length), generator=g)
    with torch.no_grad():
        got, sets = decode(model, cfg, embeds, ids, r)
        stats = {"route_miss": 0, "routed": 0}
        want = ref.lm_logits(w, ref_cfg(cfg), embeds.repeat_interleave(r, dim=0), ids, force=sets, margin=1e-5,
                             stats=stats)
        own = ref.lm_logits(w, ref_cfg(cfg), embeds.repeat_interleave(r, dim=0), ids)
    assert got.shape == (B * r, length, cfg.lm.vocab_size)
    assert stats["route_miss"] == 0 and stats["routed"] > 0
    torch.testing.assert_close(got, want, **F32_DEEP)
    torch.testing.assert_close(own, want, **F32_DEEP)  # f32 routing is the reference's own


def test_moe_matches_the_loop_over_experts(tiny):
    """The grouped route (sort, group ends, two grouped GEMMs, the shared
    groups) against the reference's loop, and the bias moving the
    selection but not the weights."""
    cfg, model, w = tiny
    layer = model.language_model.model.layers[1]
    rc = ref_cfg(cfg)
    x = torch.randn(40, cfg.lm.hidden_size, generator=torch.Generator().manual_seed(5))
    stats = {"route_miss": 0, "routed": 0}
    with torch.no_grad():
        got = kimi_lm.moe(layer.mlp, cfg.lm, x)
        want = ref._moe(w, "language_model.model.layers.1.mlp", rc, x, None, 0.0, stats)
        torch.testing.assert_close(got, want, **F32)
        idx, wts = kimi_lm.route(layer.mlp.gate, cfg.lm, x)
        scores = torch.sigmoid(x @ layer.mlp.gate.weight.t())
        biased = torch.topk(scores + layer.mlp.gate.e_score_correction_bias, cfg.lm.num_experts_per_tok).indices
        plain = torch.topk(scores, cfg.lm.num_experts_per_tok).indices
        assert torch.equal(idx, biased) and not torch.equal(idx.sort(1).values, plain.sort(1).values)
        chosen = scores.gather(1, idx)
        torch.testing.assert_close(wts, cfg.lm.routed_scaling_factor * chosen / chosen.sum(1, keepdim=True), **F32)
        # the shared expert: every token's output moves with it
        shared = layer.mlp.experts.down_proj[cfg.lm.n_routed_experts:]
        saved = shared.clone()
        shared.zero_()
        without = kimi_lm.moe(layer.mlp, cfg.lm, x)
        shared.copy_(saved)
    assert (got - without).abs().amax(dim=1).min() > 1e-3


def test_shared_prefix_equals_the_prefix_copied_per_sequence(tiny):
    """R sequences reading their clip's one prefix give the logits of each
    sequence holding its own copy of it."""
    cfg, model, _ = tiny
    r, length = 3, 4
    embeds = prefix_of(model, cfg, seed=6)
    ids = torch.randint(0, cfg.lm.vocab_size, (B * r, length), generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        shared, _ = decode(model, cfg, embeds, ids, r)
        copied, _ = decode(model, cfg, embeds.repeat_interleave(r, dim=0), ids, 1)
    torch.testing.assert_close(shared, copied, rtol=1e-6, atol=1e-6)


def test_narrate_end_to_end(tiny):
    """``narrate``: BOS first, ids in the vocabulary, the same generator the
    same ids; the steps' logits are the cached decoding's on the sampled
    ids."""
    cfg, model, _ = tiny
    video = clips(cfg)
    a = model.narrate(video, torch.Generator().manual_seed(9))
    b = model.narrate(video, torch.Generator().manual_seed(9))
    c = model.narrate(video, torch.Generator().manual_seed(10))
    assert a.shape == (B, cfg.num_return_sequences, cfg.max_text_length)
    assert (a[..., 0] == cfg.bos_token_id).all() and int(a.max()) < cfg.lm.vocab_size
    assert torch.equal(a, b) and not torch.equal(a, c)
    from helping_hand_for_egocentric_videos_torch.ops.preprocess import resize_normalize

    with torch.no_grad():
        vis = project_visual(model, narrator.encode_video(model, resize_normalize(video, cfg.visual.img_size)))
        embeds = ref.prefix_embeds(model.state_dict(), vis, model.prompt_ids)
        flat = a.reshape(B * cfg.num_return_sequences, -1)
        logits, _ = decode(model, cfg, embeds, flat[:, :-1], cfg.num_return_sequences)
    # each drawn token lies in the nucleus of its step's logits
    keep = ~sampling.nucleus_mask(logits.reshape(-1, cfg.lm.vocab_size), cfg.temperature, cfg.top_p)[1]
    assert keep[torch.arange(keep.shape[0]), flat[:, 1:].reshape(-1)].all()


def test_narrate_counts_expert_rows_and_hits_under_a_profiler(tiny):
    from torch.profiler import ProfilerActivity, profile

    from helping_hand_for_egocentric_videos_torch.utils import profiling

    cfg, model, _ = tiny
    video = clips(cfg)
    model.narrate(video, torch.Generator().manual_seed(9))  # untraced: the profiler's previous table is dropped
    with profile(activities=[ProfilerActivity.CPU]):
        model.narrate(video, torch.Generator().manual_seed(9))
    got = profiling.spans()
    lc, r, steps = cfg.lm, cfg.num_return_sequences, cfg.max_text_length - 1
    prefill_rows = B * cfg.prefix_len * lc.num_experts_per_tok * (lc.moe_layers - 1)
    decode_rows = steps * B * r * lc.num_experts_per_tok * lc.moe_layers
    assert got["hh.narrate.expert_rows"]["count"] == prefill_rows + decode_rows
    assert 0 < got["hh.narrate.experts_hit"]["count"] <= steps * lc.moe_layers * lc.n_routed_experts
    assert got["hh.narrate.moe"]["count"] == (lc.moe_layers - 1) + steps * lc.moe_layers


def test_presets_and_build_narrator(tmp_path):
    from helping_hand_for_egocentric_videos_torch.train.pretrain import build_narrator

    full = KimiNarratorConfig()
    lc = full.lm
    assert (lc.num_hidden_layers, lc.hidden_size, lc.num_attention_heads, lc.kv_lora_rank, lc.qk_nope_head_dim,
            lc.qk_rope_head_dim, lc.v_head_dim) == (27, 2048, 16, 512, 128, 64, 128)
    assert (lc.n_routed_experts, lc.moe_intermediate_size, lc.num_experts_per_tok, lc.n_shared_experts,
            lc.intermediate_size, lc.vocab_size) == (64, 1408, 6, 2, 11264, 163840)
    assert (full.visual_tokens, full.prefix_len) == (576, 600)
    meta = KimiNarratorModel(full, device="meta")
    n = sum(p.numel() for name, p in meta.named_parameters() if name.startswith("language_model."))
    assert abs(n / 1e9 - 15.96) < 0.02  # Kimi-VL-A3B's language model, 15.96 B parameters
    ncfg = NarratorCfg(model="kimi_vl_tiny", num_return_sequences=3, max_text_length=6, dtype="float32")
    model = build_narrator(ncfg, rng_seed=5, device="cpu")
    assert isinstance(model, KimiNarratorModel) and model.cfg.lm == kimi_tiny_config().lm
    bf16 = build_narrator(dataclasses.replace(ncfg, dtype="bfloat16"), rng_seed=5, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in bf16.parameters())
    path = tmp_path / "kimi.pt"
    torch.save(model.state_dict(), path)
    loaded = build_narrator(dataclasses.replace(ncfg, weights=str(path)), rng_seed=6, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(), model.state_dict().values()))


def test_cli_narrates_with_the_kimi_preset(tmp_path):
    from helping_hand_for_egocentric_videos_torch.cli import narrate as cli

    cfg = kimi_tiny_config()
    for i in range(3):
        frames = np.random.default_rng(i).integers(0, 256, (5, cfg.visual.img_size, cfg.visual.img_size, 3),
                                                   dtype=np.uint8)
        np.save(tmp_path / f"v{i}.mp4.npy", frames)
    out = tmp_path / "ids.npz"
    cli.main(["--data_dir", str(tmp_path), "--pattern", "*.npy", "--out", str(out), "--model", "kimi_vl_tiny",
              "--batch", "2", "--num_return_sequences", "3", "--max_text_length", "6", "--device", "cpu",
              "--dtype", "float32", "--threads", "1"])
    got = np.load(out)
    assert got["ids"].shape == (3, 3, 6) and (got["ids"][..., 0] == cfg.bos_token_id).all()


# ---------------------------------------------------------------- the sampler at 163840 words


def _wide_logits(rows: int, v: int, seed: int, kind: str):
    """Seeded (rows, v) f32 logits: ``peaked`` a bulk of N(0, 1) under a
    head of 1-64 tokens raised by 5-15; ``flat`` the bulk alone."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, v, generator=g)
    if kind == "peaked":
        for r in range(rows):
            k = int(torch.randint(1, 65, (1,), generator=g))
            x[r, torch.randint(0, v, (k,), generator=g)] += 5.0 + 10.0 * torch.rand(k, generator=g)
    return x


@pytest.mark.parametrize("kind", ["peaked", "flat"])
def test_plain_sampler_at_163840_words_matches_the_reference_nucleus(kind):
    """Kimi-VL's vocabulary on the plain version: the edge keeps the
    reference's nucleus (``hhbench/reference``'s ``nucleus``) but where a
    token's mass above lies within rounding of top_p, and the draws lie in
    it."""
    from hhbench.reference.narrator import nucleus

    v, t, top_p = 163840, 0.7, 0.95
    logits = _wide_logits(4, v, seed=40, kind=kind)
    scores, edge = sampling.nucleus_threshold_ref(logits, t, top_p)
    keep = scores >= edge[:, None]
    want = ~nucleus(logits, t, top_p)
    differ = keep != want
    assert differ.sum() <= 2 * logits.shape[0]  # a tie group or a token at the edge, per row
    ids = sampling.sample_next(logits, t, top_p, torch.Generator().manual_seed(3))
    assert keep[torch.arange(4), ids].all()
    assert torch.equal(ids, sampling.sample_next(logits, t, top_p, torch.Generator().manual_seed(3)))


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python -m pytest --noconftest -m cuda tests/test_torch_kimivl.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("widths", ["tiny", "full"])
def test_cuda_graph_replay_gives_the_eager_steps(cuda_device, widths, monkeypatch):
    """The first batch decodes eagerly and records every step; the next, on
    the same clips and generator, replays the graphs: the same logits at
    every step, so the same ids. ``full``: the published widths (hidden
    2048, MLA 16 x (128 + 64) over a 512 latent, 64 experts of 1408 with 6
    a token and 2 shared, 163840 words, the 336 px tower) at 2 layers (one
    dense, one MoE) and 1 tower block, in bf16."""
    if widths == "tiny":
        base = kimi_tiny_config()
        cfg = kimi_tiny_config(visual=dataclasses.replace(base.visual, width=64))  # K1/K2 take head dim >= 32
    else:
        base = KimiNarratorConfig()
        cfg = KimiNarratorConfig(visual=dataclasses.replace(base.visual, depth=1),
                                 lm=dataclasses.replace(base.lm, num_hidden_layers=2), max_text_length=9,
                                 num_return_sequences=4)
    model = KimiNarratorModel(cfg, generator=torch.Generator(cuda_device).manual_seed(0), device=cuda_device)
    model = model.to(torch.bfloat16).eval()
    video = clips(cfg, seed=20).to(cuda_device)
    seen = []
    real = narrator.sample_next
    monkeypatch.setattr(narrator, "sample_next", lambda logits, *a, **k: (seen.append(logits.clone()),
                                                                           real(logits, *a, **k))[1])
    before = latent_attention.latent_softmax.launches
    eager = model.narrate(video, torch.Generator(cuda_device).manual_seed(21))
    steps = cfg.max_text_length - 1
    dec = model.decoder(B, cuda_device)
    assert len(dec.graphs) == steps
    assert latent_attention.latent_softmax.launches - before == 2 * steps * cfg.lm.num_hidden_layers
    replayed = model.narrate(video, torch.Generator(cuda_device).manual_seed(21))
    torch.cuda.synchronize()
    for p in range(steps):
        torch.testing.assert_close(seen[steps + p], seen[p], rtol=0, atol=0, msg=f"step {p}")
    assert torch.equal(eager, replayed)


@pytest.mark.cuda
@pytest.mark.parametrize("p, t", [(600, 1), (600, 77), (12, 3), (1, 1000)])
def test_latent_softmax_kernel_matches_the_plain_version(cuda_device, p, t):
    g = torch.Generator().manual_seed(p + t)
    rows = 10240 if p == 600 else 37
    s_pre, s_tail = 20 * torch.randn(rows, p, generator=g), 20 * torch.randn(rows, t, generator=g)
    got = latent_attention.latent_softmax(s_pre.to(cuda_device), s_tail.to(cuda_device), 192**-0.5)
    want = latent_attention.latent_softmax_ref(s_pre, s_tail, 192**-0.5, torch.float32)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float().cpu(), b, rtol=1e-2, atol=1e-5)
    with pytest.raises(ValueError):
        latent_attention.latent_softmax(s_pre.to(cuda_device).t(), s_tail.to(cuda_device), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["peaked", "flat"])
def test_sampler_kernel_over_163840_words(cuda_device, kind):
    """640 x 163840 rows, the wide route: the kernel's edges and ids equal
    the plain version's (but at rounding's reach of an edge or a near
    tie), the draws in the plain version's nucleus."""
    n, v, temperature, top_p = 640, 163840, 0.7, 0.95
    logits = _wide_logits(n, v, seed=41, kind=kind)
    seed = torch.tensor([-1_234_567_890_123], device=cuda_device)
    thr = torch.empty(n, device=cuda_device)
    ids = sampling.nucleus_sample(logits.to(cuda_device), temperature, top_p, seed, threshold=thr).cpu()
    scores, edge = sampling.nucleus_threshold_ref(logits, temperature, top_p)
    assert (thr.cpu() == edge).float().mean() >= 0.99
    assert (scores >= thr.cpu()[:, None])[torch.arange(n), ids].all()
    want = sampling.sample_next_ref(logits, temperature, top_p, int(seed))
    assert (ids == want).float().mean() >= 0.99


@pytest.mark.cuda
def test_sampler_kernel_keeps_the_narrow_route_below_its_limit(cuda_device):
    """Rows up to ``MAX_VOCAB`` take the staged route, wider ones the wide
    route, up to ``MAX_WIDE_VOCAB``; both give the plain version's ids."""
    assert sampling.route(sampling.MAX_VOCAB) == "staged" and sampling.route(50257) == "staged"
    assert sampling.route(sampling.MAX_VOCAB + 1) == "wide" and sampling.route(163840) == "wide"
    seed = torch.tensor([77], device=cuda_device)
    for v in (sampling.MAX_VOCAB, sampling.MAX_VOCAB + 1):
        logits = _wide_logits(64, v, seed=v, kind="peaked")
        ids = sampling.nucleus_sample(logits.to(cuda_device), 0.7, 0.95, seed).cpu()
        assert (ids == sampling.sample_next_ref(logits, 0.7, 0.95, 77)).float().mean() >= 0.98
    with pytest.raises(ValueError, match=str(sampling.MAX_WIDE_VOCAB)):
        sampling.nucleus_sample(torch.zeros(1, sampling.MAX_WIDE_VOCAB + 1, device=cuda_device), 1.0, 0.9, seed)


# ---------------------------------------------------------------- the benchmark cell on the CPU

CELL = "kimivl4f336.b64x10"


def tiny_cell_run(seed: int = 2**31 + 11, seconds: float = 0.3):
    """``kimivl4f336.b64x10`` at the tiny size on the CPU in float32: the
    configuration file's keys at ``kimi_tiny_config``'s widths, the traffic
    at 2 clips a batch, its limits as the file states them."""
    from hhbench import harness

    cell = harness.load_cell(CELL)
    cfg = dict(cell.cfg)
    lm = kimi_tiny_config().lm
    cfg.update({k: getattr(lm, k) for k in (
        "vocab_size", "hidden_size", "intermediate_size", "moe_intermediate_size", "num_hidden_layers",
        "num_attention_heads", "n_shared_experts", "n_routed_experts", "num_experts_per_tok", "kv_lora_rank",
        "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim")}, prompt_len=4)
    cfg["visual"] = dict(cfg["visual"], img_size=56, width=32, depth=1, heads=2, num_frames=2)
    cfg["generation"] = dict(cfg["generation"], num_return_sequences=3, max_text_length=6, bos_token_id=510,
                             eos_token_id=511)
    cfg["precision"] = {k: "float32" for k in cfg["precision"]}
    params = {**cell.params, "batch": 2, "pool": 2, "warmup_s": 0, "warmup_min_s": 0, "keep_batches": 3,
              "check_batches": 2}
    cell = dataclasses.replace(cell, cfg=cfg, params=params)
    return harness.Run(cell=cell, seed=seed, seconds=seconds, trace=False, device="cpu")


def _judged(fault=None):
    from hhbench import harness, kimivl_faults

    run = tiny_cell_run()
    with kimivl_faults.planted(fault):
        result = harness.drive(run)
    ok, judged = harness.judge(result.check(), run.cell.limits)
    return ok, judged, result


def test_the_cell_passes_its_comparison_on_the_cpu():
    ok, judged, result = _judged()
    assert ok, judged
    assert judged["logit_gap"]["value"] < 1e-4 and judged["route_miss"]["value"] == 0.0
    assert judged["nucleus_miss"]["value"] == 0.0 and result.attempted >= 2


@pytest.mark.parametrize("fault", ["weights_from_biased", "shared_skipped", "tail_late", "next_clip_prefix"])
def test_each_planted_fault_fails_the_comparison(fault):
    ok, judged, _ = _judged(fault)
    assert not ok, judged


@pytest.mark.parametrize("size", ["full", "tiny"])
def test_benchmark_flops_equal_the_programs(size):
    """``hhbench/counts/kimivl.py::flops_per_clip`` on the configuration
    file equals ``utils/flops.py::kimivl_flops_per_clip`` on the program's
    configuration, at the published widths and at the CPU tests' tiny ones."""
    from hhbench.counts import kimivl as counts
    from hhbench.kimivl_weights import port_config
    from helping_hand_for_egocentric_videos_torch.utils.flops import kimivl_flops_per_clip

    from hhbench import harness

    cfg = tiny_cell_run().cell.cfg if size == "tiny" else harness.load_cell(CELL).cfg
    want = kimivl_flops_per_clip(port_config(cfg))
    assert counts.flops_per_clip(cfg) == pytest.approx(want, rel=1e-12)
    if size == "full":
        assert 9.0e12 < want < 9.1e12  # 9.04 TFLOP a narrated clip


def test_the_cell_traced_on_the_cpu_reads_its_span_metrics():
    """The traced run's line: the phase shares and the mfu read on the CPU
    (device time there is host time); the device-trace readers find no
    kernel and the launch reader no launch call, so they are left out."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("hhb_run", Path(__file__).resolve().parents[1] / "hhbench" / "run.py")
    run_py = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_py)
    from hhbench import harness

    run = tiny_cell_run()
    run.trace = True
    line = run_py.emit(run, harness.drive(run))  # this process holds JAX (conftest.py): the check skipped
    assert line["correct"] is True, line["compared"]
    shares = ["tower_device_share.kimivl", "prefill_device_share.kimivl", "decode_device_share.kimivl",
              "sample_device_share.kimivl"]
    assert set(shares) | {"step_mfu.kimivl"} <= set(line["metrics"])
    assert not {"expert_roofline.kimivl", "latent_attn_roofline.kimivl", "sample_roofline.kimivl",
                "attn_roofline.kimivl", "decode_launches_per_step.kimivl"} & set(line["metrics"])
    assert sum(line["metrics"][n]["value"] for n in shares) <= 100.0


def test_device_trace_readers_on_a_hand_made_trace():
    """The rooflines on a trace written by hand: the latent attention is each
    softmax kernel and the two GEMMs on either side of it; the experts the
    grouped-GEMM kernels with the counters; the sampler K7's kernels. Each
    share is the least time over those kernels' time."""
    from hhbench import harness, trace
    from hhbench.counts import kimivl as counts
    from hhbench.counts.peaks import PEAKS

    run = harness.Run(cell=harness.load_cell(CELL), seed=1, seconds=30, trace=True, device="cpu")
    run.traced_items, run.traced_steps = 64, 76
    gemm, soft = "nvjet_tst_128x64_64x4_1x2_h_bz_TNN", "void (anonymous namespace)::latent_softmax_kernel(...)"
    dev = []
    t = 0.0
    for _ in range(27 * 76):
        for name, dur in [("elementwise", 5.0), (gemm, 10.0), (gemm, 10.0), (soft, 5.0), (gemm, 10.0), (gemm, 10.0),
                          ("cutlass::device_kernel<GemmUniversal<GroupProblemShape<...>>>", 100.0), ("nucleus_sample_kernel<false, 16>", 20.0)]:
            dev.append((name, t, dur, "kernel"))
            t += dur
    run.trace_data = trace.Trace(window=(0.0, t), device=dev)
    read = {n: harness.load_metric(n).read for n in ("latent_attn_roofline.kimivl", "expert_roofline.kimivl",
                                                      "sample_roofline.kimivl")}
    cfg, peaks = run.cfg, PEAKS["sxm"]
    want = counts.latent_attn_least_seconds(cfg, 64, "bfloat16", peaks) / (27 * 76 * 45e-6)
    assert read["latent_attn_roofline.kimivl"](run) == pytest.approx(100 * want)
    want = counts.sample_least_seconds(cfg, 64, peaks) / (27 * 76 * 20e-6)
    assert read["sample_roofline.kimivl"](run) == pytest.approx(100 * want)
    from helping_hand_for_egocentric_videos_torch.utils import profiling

    hits, rows = 76 * 26 * 64, 64 * 600 * 6 * 25 + 76 * 640 * 6 * 26
    table = {"hh.narrate.experts_hit": {"count": hits}, "hh.narrate.expert_rows": {"count": rows}}
    real = profiling.spans
    try:
        profiling.spans = lambda: {}
        assert read["expert_roofline.kimivl"](run) is None  # no counters: a program without them
        profiling.spans = lambda: table
        got = read["expert_roofline.kimivl"](run)
    finally:
        profiling.spans = real
    want = counts.expert_least_seconds(cfg, 64, 76, hits, rows, "bfloat16", peaks) / (27 * 76 * 100e-6)
    assert got == pytest.approx(100 * want)
    run.trace_data.device[2] = ("elementwise", *run.trace_data.device[2][1:])  # a softmax beside no GEMM
    assert read["latent_attn_roofline.kimivl"](run) is None


def test_tower_attention_roofline_reads_the_tower_kernels_alone():
    """``attn_roofline.kimivl`` on a hand-made trace: K1/K2's least time for
    the traced clips over the tower's attention kernels, the latent
    attention's and the experts' kernels left out; nothing without them."""
    from hhbench import harness, trace
    from hhbench.counts.attention import tower_least_seconds_per_clip
    from hhbench.counts.peaks import PEAKS

    run = harness.Run(cell=harness.load_cell(CELL), seed=1, seconds=30, trace=True, device="cpu")
    run.traced_items, run.traced_steps = 64, 76
    names = ["void attention_bf16_kernel<64, 128>(...)", "void (anonymous namespace)::latent_softmax_kernel(...)",
             "nvjet_tst_128x64_64x4_1x2_h_bz_TNN", "void attention_bf16_kernel<64, 64>(...)"]
    dev = [(n, 1000.0 * i, 500.0, "kernel") for i, n in enumerate(names * 48)]
    run.trace_data = trace.Trace(window=(0.0, 1000.0 * len(dev)), device=dev)
    read = harness.load_metric("attn_roofline.kimivl").read
    want = tower_least_seconds_per_clip(run.cfg["visual"], "bfloat16", PEAKS["sxm"]) * 64 / (96 * 500e-6)
    assert read(run) == pytest.approx(100 * want)
    run.trace_data = trace.Trace(window=(0.0, 1000.0 * len(dev)), device=[e for e in dev if "attention_" not in e[0]])
    assert read(run) is None
