"""The train step's frozen backbone replayed from a CUDA graph
(``train/backbone_graph.py``, ``backbone_features(..., graphs=)``).

On the CPU: a call with a cache is the eager call and records nothing;
the step with its cache is the step without one; the cache's keys (a new
shape, backbone object, parameter storage or working type misses, the
same key replays), its bound, its dropping of dead and stale graphs and
its staying eager under a profiler, all through a stand-in recording that
reruns the forward into static outputs on replay. The ``cuda`` cases
record the full-width TimeSformer-L (bf16 and int8 towers) on the card:
the replays equal the eager call bit for bit, a new shape records again,
the tensors a call returned are unchanged by the next replay, and the
kernels' launch counts are the eager calls'. They import no JAX, so this
file runs on the card with ``python -m pytest --noconftest -m cuda
tests/test_torch_backbone_graph.py``.
"""

import gc
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import helping_hand_for_egocentric_videos_torch.train.step as step_module
from helping_hand_for_egocentric_videos_torch.models import (
    DecoderConfig,
    Lavila,
    LavilaConfig,
    ObjDecoder,
    SpaceTimeConfig,
    TextConfig,
)
from helping_hand_for_egocentric_videos_torch.ops.counts import read_counts, reset_counts
from helping_hand_for_egocentric_videos_torch.train import TrainConfig, TrainState, backbone_features, make_train_step
from helping_hand_for_egocentric_videos_torch.train import backbone_graph
from helping_hand_for_egocentric_videos_torch.train.backbone_graph import BackboneGraphs

T, RES, B, R, NOUNS = 4, 112, 2, 5, 16


def tiny_configs():
    """A tiny backbone the kernels take on the card (head width 64)."""
    lcfg = LavilaConfig(
        visual=SpaceTimeConfig(img_size=RES, patch_size=14, width=128, depth=2, heads=2, num_frames=T),
        text=TextConfig(width=32, heads=4, layers=2, embed_dim=16),
        embed_dim=16,
    )
    dcfg = DecoderConfig(d_model=32, nhead=4, num_layers=2, dim_feedforward=64, num_queries=13, num_classes=8,
                         feature_dim=128, text_width=32, embed_dim=16, num_frames=T,
                         patches_per_frame=lcfg.visual.patches_per_frame)
    return lcfg, dcfg


def tiny_backbone(seed=0):
    g = torch.Generator().manual_seed(seed)
    backbone = Lavila(tiny_configs()[0], generator=g)
    with torch.no_grad():  # non-zero time attention
        for blk in backbone.visual.blocks:
            blk.timeattn.qkv.weight.normal_(0.0, 0.1, generator=g)
    return backbone.requires_grad_(False)


def inputs(b=B, seed=0, res=RES, device="cpu"):
    """Normalised video (b, T, res, res, 3) and b * R captions of 77 tokens."""
    rng = np.random.default_rng(seed)
    video = torch.as_tensor(rng.normal(size=(b, T, res, res, 3)).astype(np.float32), device=device)
    tokens = np.zeros((b * R, 77), np.int64)
    for i in range(b * R):
        w = int(rng.integers(2, 6))
        tokens[i, 0], tokens[i, 1:1 + w], tokens[i, 1 + w] = 49406, rng.integers(1, 49406, size=w), 49407
    return video, torch.as_tensor(tokens, device=device)


def train_batch(seed=0):
    rng = np.random.default_rng(seed)
    _, tokens = inputs(seed=seed)
    xy = rng.uniform(0, 150, size=(B, T, 4, 2))
    return {"video": (rng.random((B, T, RES, RES, 3)) * 255).astype(np.uint8), "tokens": tokens.numpy(),
            "noun_vec": (rng.random((B, NOUNS)) < 0.3).astype(np.float32),
            "verb_vec": (rng.random((B, 8)) < 0.3).astype(np.float32),
            "boxes": np.concatenate([xy, xy + 30.0], -1).astype(np.float32),
            "nouns": rng.integers(1, NOUNS, size=(B, 3))}


def same(a, b):
    return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------------------------ the CPU


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_call_with_a_cache_is_the_eager_call(dtype):
    backbone, (lcfg, _), (video, tokens) = tiny_backbone(), tiny_configs(), inputs()
    cache = BackboneGraphs()
    eager = backbone_features(backbone, lcfg, video, tokens, dtype=dtype)
    for _ in range(2):
        assert same(backbone_features(backbone, lcfg, video, tokens, dtype=dtype, graphs=cache), eager)
    assert len(cache) == 0


def test_step_with_its_cache_is_the_step_without_one(monkeypatch):
    lcfg, dcfg = tiny_configs()
    cfg = TrainConfig(input_res=RES, rephrase_factor=R, backbone_dtype=torch.float32)
    noun_dict = torch.randn(NOUNS, 32, generator=torch.Generator().manual_seed(5))
    caches = []

    def recorded():
        caches.append(BackboneGraphs())
        return caches[-1]

    runs = []
    for make in (recorded, lambda: None):  # the step's own cache; the step with none
        monkeypatch.setattr(step_module, "BackboneGraphs", make)
        state = TrainState.create(ObjDecoder(dcfg, generator=torch.Generator().manual_seed(1)), cfg, device="cpu")
        step, gen, backbone = make_train_step(dcfg, lcfg, cfg), torch.Generator().manual_seed(11), tiny_backbone()
        for k in range(3):
            state, metrics = step(state, backbone, train_batch(k), noun_dict, gen)
        runs.append((metrics, state.decoder.state_dict()))
    (m0, p0), (m1, p1) = runs
    assert len(caches) == 1 and len(caches[0]) == 0
    assert set(m0) == set(m1) and all(torch.equal(m0[k], m1[k]) for k in m0)
    assert set(p0) == set(p1) and all(torch.equal(p0[k], p1[k]) for k in p0)


class CPUGraph:
    """A stand-in for a recorded CUDA graph: a replay reruns the forward
    on the static inputs into the static outputs."""

    def __init__(self, forward, inputs, outputs):
        self.forward, self.inputs, self.outputs = forward, inputs, outputs

    def replay(self):
        for out, new in zip(self.outputs, self.forward(*self.inputs)):
            out.copy_(new)


@pytest.fixture
def recordings(monkeypatch):
    """``backbone_graph._capture`` through a ``CPUGraph``; the list of the
    recordings made."""
    made = []

    def capture(forward, owner, storage, video, tokens):
        inputs = (video.clone(), tokens.clone())
        first = forward(*inputs)
        outputs = tuple(t.clone() for t in first)
        made.append(inputs)
        return backbone_graph._Graph(owner, storage, CPUGraph(forward, inputs, outputs), inputs, outputs, {}), first

    monkeypatch.setattr(backbone_graph, "_capture", capture)
    return made


def run(cache, backbone, video, tokens, dtype=torch.float32):
    """The cache on the eager forward of ``backbone_features``, which holds
    its backbone weakly: a ``CPUGraph`` keeps its forward, a CUDA graph
    only the device pointers."""
    lcfg, owner = tiny_configs()[0], weakref.ref(backbone)

    def forward(v, t):
        return backbone_features(owner(), lcfg, v, t, dtype=dtype)

    return cache(forward, backbone, video, tokens, lcfg, dtype)


def _moved(backbone):
    p = next(backbone.parameters())
    p.data = p.data.clone()  # the same values in new storage
    return backbone


MISSES = {
    "same key": lambda bb, v, t: (bb, v, t, torch.float32),
    "new video shape": lambda bb, v, t: (bb, inputs(b=3)[0], inputs(b=3)[1], torch.float32),
    "new tokens shape": lambda bb, v, t: (bb, v, t[:-1], torch.float32),
    "new backbone object": lambda bb, v, t: (tiny_backbone(), v, t, torch.float32),
    "moved parameter storage": lambda bb, v, t: (_moved(bb), v, t, torch.float32),
    "new working type": lambda bb, v, t: (bb, v, t, torch.bfloat16),
}


@pytest.mark.parametrize("case", list(MISSES))
def test_cache_key(recordings, case):
    backbone, (video, tokens) = tiny_backbone(), inputs()
    cache = BackboneGraphs()
    run(cache, backbone, video, tokens)
    bb, v, t, dtype = MISSES[case](backbone, video, tokens)
    got = run(cache, bb, v, t, dtype)
    assert same(got, backbone_features(bb, tiny_configs()[0], v, t, dtype=dtype))
    if case == "same key":
        assert len(recordings) == 1 and len(cache) == 1
    else:
        assert len(recordings) == 2
        # a moved backbone's old graph is stale and dropped; other keys stay
        assert len(cache) == (1 if case == "moved parameter storage" else 2)


def test_cache_bound_and_dead_backbones(recordings):
    backbone = tiny_backbone()
    cache = BackboneGraphs()
    shapes = [inputs(b=b) for b in range(1, backbone_graph.MAX_GRAPHS + 2)]
    for video, tokens in shapes:
        run(cache, backbone, video, tokens)
    n = backbone_graph.MAX_GRAPHS
    assert len(recordings) == n and len(cache) == n  # the last shape ran eagerly
    for video, tokens in shapes:  # the first ones replay, the last stays eager
        eager = backbone_features(backbone, tiny_configs()[0], video, tokens, dtype=torch.float32)
        assert same(run(cache, backbone, video, tokens), eager)
    assert len(recordings) == n
    del backbone
    gc.collect()
    other = tiny_backbone(seed=1)
    run(cache, other, *shapes[-1])  # the dead backbone's graphs are dropped: room to record
    assert len(recordings) == n + 1 and len(cache) == 1


def test_replays_return_tensors_the_caller_owns(recordings):
    backbone, cache = tiny_backbone(), BackboneGraphs()
    lcfg = tiny_configs()[0]
    a, b = inputs(seed=0), inputs(seed=1)
    run(cache, backbone, *a)
    first = run(cache, backbone, *a)  # a replay
    kept = tuple(x.clone() for x in first)
    second = run(cache, backbone, *b)  # the next replay, on other inputs
    assert same(first, kept) and same(second, backbone_features(backbone, lcfg, *b, dtype=torch.float32))
    assert not same(first, second)


def test_no_recording_under_a_profiler(recordings):
    backbone, cache, (video, tokens) = tiny_backbone(), BackboneGraphs(), inputs()
    with profile(activities=[ProfilerActivity.CPU]):
        run(cache, backbone, video, tokens)
    assert recordings == [] and len(cache) == 0
    run(cache, backbone, video, tokens)
    assert len(recordings) == 1


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc "
                    "(python -m pytest --noconftest -m cuda tests/test_torch_backbone_graph.py)")
    return torch.device("cuda")


def full_width(device, int8):
    from helping_hand_for_egocentric_videos_torch.models import lavila, quantize_lavila_params

    lcfg = lavila.timesformer_large_config(num_frames=T)
    gen = torch.Generator(device=device).manual_seed(7)
    backbone = Lavila(lcfg, generator=gen, device=device).requires_grad_(False)
    with torch.no_grad():  # a non-zero time attention
        for blk in backbone.visual.blocks:
            blk.timeattn.qkv.weight.normal_(0.0, 0.02, generator=gen)
            blk.timeattn.proj.weight.normal_(0.0, 0.02, generator=gen)
    return lcfg, quantize_lavila_params(backbone) if int8 else backbone


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_cuda_replay_is_the_eager_forward(cuda_device, int8):
    lcfg, backbone = full_width(cuda_device, int8)
    res = lcfg.visual.img_size
    a, b, c = (inputs(b=n, seed=s, res=res, device=cuda_device) for n, s in ((2, 0), (2, 1), (3, 2)))

    def call(x, cache=None):
        reset_counts()
        out = backbone_features(backbone, lcfg, *x, dtype=torch.bfloat16, graphs=cache)
        torch.cuda.synchronize()
        return out, read_counts()

    (eager_a, n_eager), (eager_b, _), (eager_c, _) = call(a), call(b), call(c)
    assert same(call(a)[0], eager_a)  # the eager forward repeats its bits
    assert any(n_eager.values())
    cache = BackboneGraphs()
    first, n_first = call(a, cache)  # the warm-up's outputs; then the recording
    replayed, n_replay = call(a, cache)
    assert len(cache) == 1 and same(first, eager_a) and same(replayed, eager_a)
    assert n_first == n_eager and n_replay == n_eager  # what the device ran, not what was recorded
    kept = tuple(x.clone() for x in replayed)
    other, _ = call(b, cache)  # the next replay, on other inputs
    assert same(other, eager_b) and same(replayed, kept)
    shaped, _ = call(c, cache)  # a new shape records again
    assert len(cache) == 2 and same(shaped, eager_c) and same(call(c, cache)[0], eager_c)


@pytest.mark.cuda
def test_cuda_model_axis_stays_eager(cuda_device, monkeypatch):
    lcfg = tiny_configs()[0]
    backbone = tiny_backbone().to(cuda_device)
    video, tokens = inputs(device=cuda_device)
    real, given = step_module.lavila_forward, []

    def forward(*args, mp=None, **kw):
        given.append(mp)
        return real(*args, **kw)

    monkeypatch.setattr(step_module, "lavila_forward", forward)
    mp, cache = object(), BackboneGraphs()
    for _ in range(2):
        backbone_features(backbone, lcfg, video, tokens, dtype=torch.float32, mp=mp, graphs=cache)
    assert given == [mp, mp] and len(cache) == 0


@pytest.mark.cuda
def test_cuda_step_replays_its_backbone(cuda_device):
    """Three steps of the tiny f32 trainer on the card: the step's own
    cache against the same steps with none, bit for bit."""
    lcfg, dcfg = tiny_configs()
    cfg = TrainConfig(input_res=RES, rephrase_factor=R, backbone_dtype=torch.float32)
    noun_dict = torch.randn(NOUNS, 32, generator=torch.Generator().manual_seed(5)).to(cuda_device)
    backbone = tiny_backbone().to(cuda_device)
    runs = []
    for graphs in (True, False):
        state = TrainState.create(ObjDecoder(dcfg, generator=torch.Generator().manual_seed(1)), cfg,
                                  device=cuda_device)
        step = make_train_step(dcfg, lcfg, cfg)
        gen = torch.Generator(device=cuda_device).manual_seed(11)
        seen = []

        def tap(*args, **kw):
            if not graphs:
                kw.pop("graphs")
            seen.append(kw.get("graphs"))
            return real(*args, **kw)

        real = step_module.backbone_features
        step_module.backbone_features = tap
        try:
            for k in range(3):
                state, metrics = step(state, backbone, train_batch(k), noun_dict, gen)
        finally:
            step_module.backbone_features = real
        runs.append((metrics, state.decoder.state_dict(), seen))
    (m0, p0, s0), (m1, p1, s1) = runs
    assert len(s0[0]) == 1 and s1 == [None] * 3
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
