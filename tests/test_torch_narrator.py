"""LaViLa's narrator on the CPU at tiny widths, in float32, against the
plain reference of ``tests/reference_narrator.py``.

The model (``narrator_tiny_config``): a 2-block tower of width 32 on 28 px
clips of 2 frames, 8 latents, a 4-block GPT-2 of width 64 with 4 heads and
a 97-word vocabulary (cross-attention in blocks 0 and 2), 2 clips x 3
sequences of 6 positions. Every weight is drawn anew (biases, gates and
LayerNorms too), so each term of the forward shows.

Tolerances: the port and the reference compute the same f32 arithmetic in
another order (SDPA against a masked softmax, the CLS token carried apart,
per-clip against repeated latents), so they differ by rounding alone:
``F32`` (1e-5 relative and absolute) on the pooler and the sampler's
scores, ``F32_DEEP`` (1e-4) on what passes through the tower or the
language model's blocks, where those differences add up over the layers.
The per-clip cross cache against keys made per sequence is held to
``F32`` too: the same products on the same rows.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

import reference_narrator as ref
from helping_hand_for_egocentric_videos_torch.core.config import NarratorCfg
from helping_hand_for_egocentric_videos_torch.models import gpt2, narrator
from helping_hand_for_egocentric_videos_torch.models.narrator import (
    NarratorModel,
    attention_pool,
    encode_video,
    narrator_tiny_config,
)
from helping_hand_for_egocentric_videos_torch.ops import decode_attention, sampling
from helping_hand_for_egocentric_videos_torch.ops.preprocess import resize_normalize

F32 = dict(rtol=1e-5, atol=1e-5)
F32_DEEP = dict(rtol=1e-4, atol=1e-4)
B = 2


def tiny_ncfg(**kw) -> NarratorCfg:
    """``build_narrator``'s fields of the tiny preset."""
    return NarratorCfg(model="vclm_tiny", num_return_sequences=3, max_text_length=6, **kw)


def _is_norm_weight(name: str) -> bool:
    return name.endswith(".gamma") or (name.endswith(".weight") and any(
        k in name.split(".")[-2] for k in ("ln", "norm")))


def randomize(model: NarratorModel, seed: int = 0) -> dict:
    """Every parameter of ``model`` drawn anew (the ``beta`` buffers stay
    zero, as coca's are) -> its f32 state dict."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(".beta"):
                continue
            z = torch.randn(t.shape, generator=g)
            if _is_norm_weight(name):
                t.copy_(1.0 + 0.1 * z)
            elif name.endswith("cross_attn_gate"):
                t.copy_(0.5 + 0.1 * z)
            elif name.endswith(("wte.weight", "wpe.weight", ".bias")) or "embed" in name or "cls_token" in name:
                t.copy_(0.1 * z)  # wte at 0.1: logits of a few units, a nucleus of many tokens
            elif name.endswith("img_queries"):
                t.copy_(z)
            else:  # Conv1D weights are (in, out), nn.Linear's (out, in)
                fan_in = t.shape[0] if name.startswith("text_decoder") else t.shape[-1]
                t.copy_(z / math.sqrt(fan_in))
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def tiny():
    cfg = narrator_tiny_config()
    model = NarratorModel(cfg, generator=torch.Generator().manual_seed(0)).eval()
    w = randomize(model)
    return cfg, model, w


def clips(cfg, seed: int = 1, b: int = B):
    g = torch.Generator().manual_seed(seed)
    v = cfg.visual
    return torch.randint(0, 256, (b, v.num_frames, v.img_size, v.img_size, 3), generator=g, dtype=torch.uint8)


def test_pooler_matches_reference(tiny):
    cfg, model, w = tiny
    g = torch.Generator().manual_seed(3)
    tokens = torch.randn(B, 1 + cfg.visual.patches_per_frame * cfg.visual.num_frames, cfg.visual.width, generator=g)
    with torch.no_grad():
        got = attention_pool(model, tokens)
    assert got.shape == (B, cfg.num_img_queries, cfg.lm.n_embd)
    torch.testing.assert_close(got, ref.pool(w, cfg, tokens), **F32)


def _decode(model, cfg, latents, ids, r):
    """Prefill then teacher-forced cached decoding -> (logits (N, L, V), cache)."""
    n, length = ids.shape
    cache = gpt2.NarrateCache(cfg.lm, latents.shape[0], r, length, latents.shape[1], dtype=torch.float32,
                              device="cpu")
    gpt2.prefill_cross(model.text_decoder, cfg.lm, latents, cache)
    steps = [gpt2.decode_step(model.text_decoder, cfg.lm, cache, ids[:, p], p) for p in range(length)]
    return torch.stack(steps, dim=1), cache


def test_full_forward_matches_reference(tiny):
    """uint8 clips -> tower -> pooler -> teacher-forced logits of every
    position (prefill, then a cached decode step at each position)."""
    cfg, model, w = tiny
    r, length = cfg.num_return_sequences, cfg.max_text_length
    video = resize_normalize(clips(cfg), cfg.visual.img_size)
    ids = torch.randint(0, cfg.lm.vocab_size, (B * r, length), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        tokens = encode_video(model, video)
        latents = attention_pool(model, tokens)
        logits, _ = _decode(model, cfg, latents, ids, r)
        want_tokens = ref.timesformer(w, cfg.visual, video)
        want_latents = ref.pool(w, cfg, want_tokens)
        want = ref.lm_logits(w, cfg.lm, ids, want_latents.repeat_interleave(r, dim=0))
    torch.testing.assert_close(tokens, want_tokens, **F32_DEEP)
    torch.testing.assert_close(latents, want_latents, **F32_DEEP)
    assert logits.shape == (B * r, length, cfg.lm.vocab_size) and logits.dtype == torch.float32
    torch.testing.assert_close(logits, want, **F32_DEEP)


def test_cached_decoding_matches_full_forward_at_every_step(tiny):
    cfg, model, w = tiny
    r, length = cfg.num_return_sequences, cfg.max_text_length
    g = torch.Generator().manual_seed(5)
    latents = torch.randn(B, cfg.num_img_queries, cfg.lm.n_embd, generator=g)
    ids = torch.randint(0, cfg.lm.vocab_size, (B * r, length), generator=g)
    with torch.no_grad():
        got, _ = _decode(model, cfg, latents, ids, r)
        want = ref.lm_logits(w, cfg.lm, ids, latents.repeat_interleave(r, dim=0))
    for p in range(length):
        torch.testing.assert_close(got[:, p], want[:, p], **F32_DEEP, msg=f"step {p}")


def test_per_clip_cross_cache_equals_keys_made_per_sequence(tiny):
    """The cross keys and values held once per clip are the rows of those
    made from the latents repeated per sequence, and decoding over them
    gives the logits of a cache with one clip a sequence."""
    cfg, model, _ = tiny
    r, length = cfg.num_return_sequences, cfg.max_text_length
    g = torch.Generator().manual_seed(6)
    latents = torch.randn(B, cfg.num_img_queries, cfg.lm.n_embd, generator=g)
    ids = torch.randint(0, cfg.lm.vocab_size, (B * r, length), generator=g)
    with torch.no_grad():
        per_clip, cache = _decode(model, cfg, latents, ids, r)
        per_seq, expanded = _decode(model, cfg, latents.repeat_interleave(r, dim=0), ids, 1)
    assert cache.cross.shape[2] == B and expanded.cross.shape[2] == B * r
    torch.testing.assert_close(cache.cross.repeat_interleave(r, dim=2), expanded.cross, **F32)
    torch.testing.assert_close(per_clip, per_seq, **F32)
    self_bytes, cross_bytes = cache.nbytes
    assert self_bytes == 4 * cfg.lm.n_layer * 2 * B * r * cfg.lm.n_embd * length
    assert cross_bytes == 4 * len(cfg.lm.cross_layers) * 2 * B * cfg.num_img_queries * cfg.lm.n_embd


def test_nucleus_mask_and_temperature_match_reference():
    g = torch.Generator().manual_seed(7)
    logits = 3.0 * torch.randn(64, 97, generator=g)
    for temperature, top_p in ((0.7, 0.95), (1.0, 0.5), (0.3, 0.99)):
        scores, drop = sampling.nucleus_mask(logits, temperature, top_p)
        want_scores, want_drop = ref.nucleus(logits, temperature, top_p)
        torch.testing.assert_close(scores, want_scores, **F32)
        assert not drop.all(dim=-1).any()  # the most likely token is always kept
        # the two forms sum the mass in another order: they may part only at the boundary
        probs, order = torch.sort(scores.softmax(-1), dim=-1, descending=True)
        before = torch.empty_like(probs).scatter_(1, order, probs.cumsum(-1) - probs)
        differ = drop != want_drop
        assert ((before[differ] - top_p).abs() < 1e-5).all()


def test_sampler_draws_from_the_nucleus_and_a_fixed_generator_fixes_the_ids():
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]]))  # top_p 0.9 keeps the first three
    n = 20000
    batch = logits.expand(n, -1).contiguous()
    ids = sampling.sample_next(batch, 1.0, 0.9, torch.Generator().manual_seed(8))
    again = sampling.sample_next(batch, 1.0, 0.9, torch.Generator().manual_seed(8))
    other = sampling.sample_next(batch, 1.0, 0.9, torch.Generator().manual_seed(9))
    assert ids.dtype == torch.int64 and torch.equal(ids, again) and not torch.equal(ids, other)
    freq = torch.bincount(ids, minlength=4).double() / n
    want = torch.tensor([0.5, 0.3, 0.15, 0.0], dtype=torch.float64) / 0.95
    # binomial standard error at n = 20000 is under 0.004: five of them
    assert (freq - want).abs().max() < 0.02 and freq[3] == 0.0
    cold = sampling.sample_next(batch, 0.05, 0.9, torch.Generator().manual_seed(8))
    assert (cold == 0).all()  # a low temperature leaves the top token alone in the nucleus


def _above(scores):
    """Each score's softmax mass of the scores strictly greater, in float64."""
    s = scores.double()
    p = (s - s.amax(-1, keepdim=True)).exp()
    p = p / p.sum(-1, keepdim=True)
    sv, order = torch.sort(s, dim=-1, descending=True)
    ps = p.gather(1, order)
    cum = ps.cumsum(-1) - ps
    pos = torch.arange(sv.shape[1], device=sv.device).expand_as(sv)
    new = torch.cat([torch.ones_like(sv[:, :1], dtype=torch.bool), sv[:, 1:] != sv[:, :-1]], 1)
    first = torch.where(new, pos, 0).cummax(-1).values  # a tie group's first member
    return torch.empty_like(cum).scatter_(1, order, cum.gather(1, first))


def _parts_at_the_edge(keep, want_keep, scores, top_p, tol=1e-5):
    """Two kept sets of the same scores part only where a token's mass above
    lies within ``tol`` of ``top_p``: sums in another order."""
    differ = keep != want_keep
    return bool(((_above(scores)[differ] - top_p).abs() < tol).all())


@pytest.mark.parametrize("temperature, top_p", [(0.7, 0.95), (1.0, 0.5), (0.3, 0.99)])
def test_plain_threshold_matches_reference(temperature, top_p):
    """The plain version of the kernel's edge keeps the reference's nucleus
    (``reference_narrator.nucleus``, ``hhbench/reference/narrator.py``'s
    rule), but where the mass above a token lies at ``top_p`` within
    rounding, the tolerance of ``test_nucleus_mask_and_temperature_match_reference``."""
    g = torch.Generator().manual_seed(7)
    logits = 3.0 * torch.randn(64, 97, generator=g)
    scores, edge = sampling.nucleus_threshold_ref(logits, temperature, top_p)
    want_scores, want_drop = ref.nucleus(logits, temperature, top_p)
    torch.testing.assert_close(scores, want_scores, **F32)
    keep = scores >= edge[:, None]
    assert keep.gather(1, scores.argmax(-1, keepdim=True)).all()  # the most likely token always kept
    assert _parts_at_the_edge(keep, ~want_drop, scores, top_p)


def test_philox_known_answers():
    """The sampler's random bits: Random123's known answers of Philox4x32-10."""
    cases = (((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)))
    for ctr, key, want in cases:
        got = sampling._philox(*(torch.tensor([c]) for c in ctr), *key)
        assert tuple(int(w) for w in got) == want
    u = sampling.philox_uniform(-5, 3, 1000)
    assert u.dtype == torch.float32 and (u > 0).all() and (u < 1).all()
    assert abs(u.double().mean().item() - 0.5) < 0.02


@pytest.mark.parametrize("case", ["dominant", "neg_inf", "ties"])
def test_plain_sampler_edge_cases(case):
    """A row with one dominant token, rows with -inf entries and rows whose
    edge falls on exact ties, on the CPU route."""
    n = 20000
    gen = torch.Generator().manual_seed(21)
    if case == "dominant":
        row = torch.zeros(97)
        row[13] = 30.0
        logits = row.expand(n, -1).contiguous()
        scores, edge = sampling.nucleus_threshold_ref(logits, 1.0, 0.95)
        assert torch.equal((scores >= edge[:, None]).nonzero()[:, 1], torch.full((n,), 13))
        assert (sampling.sample_next(logits, 1.0, 0.95, gen) == 13).all()
    elif case == "neg_inf":
        row = torch.randn(97, generator=torch.Generator().manual_seed(3))
        row[::3] = float("-inf")
        logits = row.expand(n, -1).contiguous()
        for top_p in (0.9, 1.0):
            ids = sampling.sample_next(logits, 0.7, top_p, gen)
            assert torch.isfinite(row[ids]).all()
        scores, edge = sampling.nucleus_threshold_ref(logits[:1], 0.7, 1.0)
        assert torch.equal(scores[0] >= edge, torch.isfinite(row))  # top_p 1 keeps every finite token
        dead = torch.full((2, 97), float("-inf"))
        assert sampling.nucleus_threshold_ref(dead, 0.7, 0.95)[1].eq(float("inf")).all()
        assert (sampling.sample_next(dead, 0.7, 0.95, gen) == 0).all()  # no finite logit: 0
    else:
        # masses e^2, 3 x e, 1, e^-1: the ties' mass above is 0.437 of the row's
        row = torch.tensor([2.0, 1.0, 1.0, 1.0, 0.0, -1.0])
        logits = row.expand(n, -1).contiguous()
        for top_p, kept in ((0.5, 4), (0.4, 1), (0.0, 1)):
            scores, edge = sampling.nucleus_threshold_ref(logits[:1], 1.0, top_p)
            assert torch.equal(scores[0] >= edge, torch.arange(6) < kept), top_p
        ids = sampling.sample_next(logits, 1.0, 0.5, gen)
        freq = torch.bincount(ids, minlength=6).double() / n
        w = torch.tensor([math.e ** 2, math.e, math.e, math.e, 0.0, 0.0], dtype=torch.float64)
        assert (freq - w / w.sum()).abs().max() < 0.02 and freq[4:].sum() == 0


def test_narrate_end_to_end(tiny):
    """ids (B, R, L), BOS first, the same for the same generator; each
    sampled token (up to a sequence's first EOS, after which it is padded)
    lies in the reference's nucleus of the reference's logits,
    teacher-forced on the sampled ids."""
    cfg, model, w = tiny
    video = clips(cfg, seed=10)
    ids = model.narrate(video, torch.Generator().manual_seed(11))
    again = model.narrate(video, torch.Generator().manual_seed(11))
    r, length = cfg.num_return_sequences, cfg.max_text_length
    assert ids.shape == (B, r, length) and ids.dtype == torch.int64
    assert torch.equal(ids, again) and (ids[:, :, 0] == cfg.bos_token_id).all()
    assert ((ids >= 0) & (ids < cfg.lm.vocab_size)).all()
    flat = ids.reshape(B * r, length)
    with torch.no_grad():
        lat = ref.pool(w, cfg, ref.timesformer(w, cfg.visual, resize_normalize(video, cfg.visual.img_size)))
        logits = ref.lm_logits(w, cfg.lm, flat, lat.repeat_interleave(r, dim=0))
    _, drop = ref.nucleus(logits[:, :-1].reshape(-1, cfg.lm.vocab_size), cfg.temperature, cfg.top_p)
    drawn = flat[:, 1:].reshape(-1)
    eos = (flat[:, 1:] == cfg.eos_token_id).int()
    sampled = (eos.cumsum(1) - eos == 0).reshape(-1)  # up to and including the first EOS
    outside = drop[torch.arange(drawn.numel()), drawn]
    assert sampled.sum() > 10 and not outside[sampled].any()
    assert len(set(drawn.tolist())) > 5  # a nucleus of many tokens, not one


def test_narrate_pads_a_finished_sequence_with_eos(tiny, monkeypatch):
    cfg, model, _ = tiny
    eos = cfg.eos_token_id
    real = narrator.sample_next
    calls = []

    def eos_at_step_one(logits, *args, **kwargs):
        out = real(logits, *args, **kwargs)
        calls.append(1)
        if len(calls) == 2:  # the second token of sequences 0 and 4 is EOS
            out[[0, 4]] = eos
        elif (out == eos).any():
            out[out == eos] = 0
        return out

    monkeypatch.setattr(narrator, "sample_next", eos_at_step_one)
    ids = model.narrate(clips(cfg, seed=12), torch.Generator().manual_seed(13)).reshape(-1, cfg.max_text_length)
    assert len(calls) == cfg.max_text_length - 1  # every step runs
    assert (ids[[0, 4], 2:] == eos).all()
    assert not (ids[[1, 2, 3, 5], 1:] == eos).any()


def test_bf16_model_holds_no_f32_weights():
    from helping_hand_for_egocentric_videos_torch.train.pretrain import build_narrator

    model = build_narrator(tiny_ncfg(dtype="bfloat16"), rng_seed=3, device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    cfg = model.cfg
    ids = model.narrate(clips(cfg, seed=14), torch.Generator().manual_seed(15))
    assert ids.shape == (B, cfg.num_return_sequences, cfg.max_text_length)


def test_build_narrator_loads_a_state_dict(tiny, tmp_path):
    from helping_hand_for_egocentric_videos_torch.train.pretrain import build_narrator

    _, model, w = tiny
    path = tmp_path / "narrator.pth"
    torch.save(w, path)
    got = build_narrator(tiny_ncfg(weights=str(path), dtype="float32"), device="cpu")
    sd = got.state_dict()
    assert sd.keys() == w.keys() and all(torch.equal(sd[k], w[k]) for k in w)


def test_cli_narrates_a_clip_store(tiny, tmp_path):
    """``cli/narrate.py`` over .mp4.npy clips through the loader: the ids of
    ``narrate`` on the same frames with the same generators."""
    from helping_hand_for_egocentric_videos_torch.cli import narrate as cli
    from helping_hand_for_egocentric_videos_torch.train.pretrain import build_narrator

    rng = np.random.default_rng(16)
    for i in range(3):
        np.save(tmp_path / f"v{i}.mp4.npy", rng.integers(0, 256, size=(9 + i, 28, 28, 3), dtype=np.uint8))
    out = tmp_path / "out" / "ids.npz"
    cli.main(["--data_dir", str(tmp_path), "--out", str(out), "--model", "vclm_tiny", "--batch", "2",
              "--seed", "5", "--dtype", "float32", "--device", "cpu", "--threads", "2",
              "--num_return_sequences", "3", "--max_text_length", "6"])
    got = np.load(out)
    cfg = narrator_tiny_config()
    assert got["ids"].shape == (3, cfg.num_return_sequences, cfg.max_text_length)
    assert [p.split("/")[-1] for p in got["paths"]] == ["v0.mp4", "v1.mp4", "v2.mp4"]
    model = build_narrator(tiny_ncfg(dtype="float32"), rng_seed=5, device="cpu")
    frames = [np.load(tmp_path / f"v{i}.mp4.npy")[np.linspace(0, 8 + i, 2).round().astype(int)] for i in range(3)]
    want = [model.narrate(torch.as_tensor(np.stack(frames[lo:lo + 2])),
                          torch.Generator().manual_seed(5 * 1_000_003 + k)) for k, lo in enumerate((0, 2))]
    np.testing.assert_array_equal(got["ids"], torch.cat(want).numpy())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python -m pytest --noconftest -m cuda tests/test_torch_narrator.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("widths", ["tiny", "full"])
def test_cuda_graph_replay_gives_the_eager_steps(cuda_device, widths, monkeypatch):
    """The first batch of a shape decodes eagerly and records every step;
    the next, on the same clips with the same generator, replays the
    graphs: the same logits at every step, so the same ids. ``full``: the
    published widths (GPT-2 XL's 1600, 25 heads, the 50257 vocabulary, the
    336 px tower) at depth 2 and 1 tower block, in bf16. At both widths the
    attention calls of every step take the decode-attention kernel (K8),
    eager and recorded into the graphs."""
    from helping_hand_for_egocentric_videos_torch.models.narrator import NarratorConfig

    if widths == "tiny":  # a tower of head dim 32, the least the card's divided-attention kernel takes, and
        # one language-model head of 64, the width the card's decode-attention kernel takes
        tiny_cfg = narrator_tiny_config()
        cfg = narrator_tiny_config(visual=dataclasses.replace(tiny_cfg.visual, width=64),
                                   lm=dataclasses.replace(tiny_cfg.lm, n_head=1))
    else:
        base = NarratorConfig()
        cfg = NarratorConfig(visual=dataclasses.replace(base.visual, depth=1),
                              lm=dataclasses.replace(base.lm, n_layer=2), max_text_length=9)
    model = NarratorModel(cfg, generator=torch.Generator(cuda_device).manual_seed(0), device=cuda_device)
    model = model.to(torch.bfloat16).eval()
    video = clips(cfg, seed=20).to(cuda_device)
    seen = []
    real = narrator.sample_next
    monkeypatch.setattr(narrator, "sample_next", lambda logits, *a, **k: (seen.append(logits.clone()),
                                                                           real(logits, *a, **k))[1])
    before = decode_attention.launches()
    eager = model.narrate(video, torch.Generator(cuda_device).manual_seed(21))
    dec = model.decoder(B, cfg.num_img_queries, cuda_device)
    steps = cfg.max_text_length - 1
    assert len(dec.graphs) == steps
    # every attention call of a step takes the decode-attention kernel, eager and recorded
    per_step = cfg.lm.n_layer + len(cfg.lm.cross_layers)
    assert dec.kernel_calls == [per_step] * steps
    assert decode_attention.launches() - before == 2 * steps * per_step
    replayed = model.narrate(video, torch.Generator(cuda_device).manual_seed(21))
    torch.cuda.synchronize()
    for p in range(steps):
        torch.testing.assert_close(seen[steps + p], seen[p], rtol=0, atol=0, msg=f"step {p}")
    assert torch.equal(eager, replayed)


def _gpt2_scale_logits(rows: int, v: int, seed: int):
    """Seeded (rows, v) f32 logits of GPT-2's scale (a bulk near -100 with a
    spread of 3 under a head of 1-64 tokens raised by 5-20), and rows that
    take the kernel's other paths: 0 flat; 1 with 20000 tokens within 1e-3
    of each other at the edge (more than its list holds: the row
    rescanned); 2 of integers (exact ties everywhere); 3 with every fifth
    entry -inf; 4 one dominant token."""
    g = torch.Generator().manual_seed(seed)
    x = -100.0 + 3.0 * torch.randn(rows, v, generator=g)
    for r in range(rows):
        k = int(torch.randint(1, 65, (1,), generator=g))
        x[r, torch.randint(0, v, (k,), generator=g)] += 5.0 + 15.0 * torch.rand(k, generator=g)
    x[0] = 0.01 * torch.randn(v, generator=g)
    x[1] = -10.0 + 5.0 * torch.rand(v, generator=g)
    x[1, :20000] = 1e-3 * torch.rand(20000, generator=g)
    x[2] = torch.round(3.0 * torch.randn(v, generator=g))
    x[3, ::5] = float("-inf")
    x[4] = -100.0
    x[4, 7] = 0.0
    return x


@pytest.mark.cuda
def test_sampler_kernel_matches_the_plain_version_at_gpt2_scale(cuda_device):
    """At the narrator's (640, 50257): the kernel's edge keeps the plain
    version's nucleus but at rounding's reach of top_p, its draws lie in
    that nucleus, and on the same seed they are the plain version's ids but
    where a near tie falls otherwise."""
    n, v, temperature, top_p = 640, 50257, 0.7, 0.95
    logits = _gpt2_scale_logits(n, v, seed=30)
    seed = torch.tensor([-7_212_345_678_901_234_567], device=cuda_device)
    thr = torch.empty(n, device=cuda_device)
    before = sampling.nucleus_sample.launches
    ids = sampling.nucleus_sample(logits.to(cuda_device), temperature, top_p, seed, threshold=thr).cpu()
    assert sampling.nucleus_sample.launches == before + 1
    scores, edge = sampling.nucleus_threshold_ref(logits, temperature, top_p)
    keep, want_keep = scores >= thr.cpu()[:, None], scores >= edge[:, None]
    assert _parts_at_the_edge(keep, want_keep, scores, top_p)
    assert (thr.cpu() == edge).float().mean() >= 0.99
    rows = torch.arange(n)
    assert keep[rows, ids].all()
    outside = ~want_keep[rows, ids]
    assert ((_above(scores)[rows, ids][outside] - top_p).abs() < 1e-5).all()
    assert ids[4] == 7 and torch.isfinite(logits[3, ids[3]])
    want = sampling.sample_next_ref(logits, temperature, top_p, int(seed))
    assert (ids == want).float().mean() >= 0.99


@pytest.mark.cuda
def test_sampler_kernel_draws_from_the_nucleus_and_a_fixed_generator_fixes_the_ids(cuda_device):
    """``test_sampler_draws_from_the_nucleus_and_a_fixed_generator_fixes_the_ids``
    through the kernel: the frequencies of a 4-token row at n = 20000."""
    logits = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]], device=cuda_device))
    n = 20000
    batch = logits.expand(n, -1).contiguous()
    ids = sampling.sample_next(batch, 1.0, 0.9, torch.Generator(cuda_device).manual_seed(8))
    again = sampling.sample_next(batch, 1.0, 0.9, torch.Generator(cuda_device).manual_seed(8))
    other = sampling.sample_next(batch, 1.0, 0.9, torch.Generator(cuda_device).manual_seed(9))
    assert ids.dtype == torch.int64 and ids.device == batch.device
    assert torch.equal(ids, again) and not torch.equal(ids, other)
    freq = torch.bincount(ids.cpu(), minlength=4).double() / n
    want = torch.tensor([0.5, 0.3, 0.15, 0.0], dtype=torch.float64) / 0.95
    assert (freq - want).abs().max() < 0.02 and freq[3] == 0.0
    cold = sampling.sample_next(batch, 0.05, 0.9, torch.Generator(cuda_device).manual_seed(8))
    assert (cold == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("temperature, top_p", [(0.7, 0.95), (1.0, 0.5), (0.3, 0.99), (1.0, 0.0), (1.0, 1.0)])
def test_sampler_kernel_at_the_tiny_vocabulary(cuda_device, temperature, top_p):
    """V = 97 (the tiny narrator's): the kernel's edge and ids against the
    plain version's; the wrapper refuses what the kernel cannot take."""
    g = torch.Generator().manual_seed(31)
    logits = 3.0 * torch.randn(256, 97, generator=g)
    logits[:8] = torch.round(logits[:8])  # ties
    logits[8, ::2] = float("-inf")
    seed = torch.tensor([12345], device=cuda_device)
    thr = torch.empty(256, device=cuda_device)
    ids = sampling.nucleus_sample(logits.to(cuda_device), temperature, top_p, seed, threshold=thr).cpu()
    scores, edge = sampling.nucleus_threshold_ref(logits, temperature, top_p)
    assert _parts_at_the_edge(scores >= thr.cpu()[:, None], scores >= edge[:, None], scores, top_p)
    assert (ids == sampling.sample_next_ref(logits, temperature, top_p, 12345)).float().mean() >= 0.98
    wide = torch.zeros(1, sampling.MAX_VOCAB + 1, device=cuda_device)
    with pytest.raises(ValueError, match=str(sampling.MAX_VOCAB)):
        sampling.nucleus_sample(wide, 1.0, 0.9, seed)
    with pytest.raises(TypeError):
        sampling.nucleus_sample(logits.to(cuda_device, torch.float64), 1.0, 0.9, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("v", [1, 2, 3, 5, 4099])
def test_sampler_kernel_at_edge_shapes(cuda_device, v):
    """Rows of 1-5 and 4099 tokens (each row starting at another offset from
    a 16-byte boundary), more rows than the kernel has blocks (each block
    walks several), a row without a finite logit and an empty batch: the
    plain version's edges and ids."""
    n = 3000
    g = torch.Generator().manual_seed(32 + v)
    logits = 2.0 * torch.randn(n, v, generator=g)
    logits[7] = float("-inf")
    logits[8, 0] = float("-inf")
    seed = torch.tensor([-3], device=cuda_device)
    thr = torch.empty(n, device=cuda_device)
    ids = sampling.nucleus_sample(logits.to(cuda_device), 0.7, 0.9, seed, threshold=thr).cpu()
    _, edge = sampling.nucleus_threshold_ref(logits, 0.7, 0.9)
    assert (thr.cpu() == edge).float().mean() >= 0.99 and thr[7] == float("inf") and ids[7] == 0
    assert (ids == sampling.sample_next_ref(logits, 0.7, 0.9, -3)).float().mean() >= 0.99
    empty = sampling.nucleus_sample(torch.empty(0, v, device=cuda_device), 0.7, 0.9, seed)
    assert empty.shape == (0,) and empty.dtype == torch.int64
