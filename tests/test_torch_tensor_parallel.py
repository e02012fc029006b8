"""Tensor parallelism of the frozen backbone (the mesh's ``model`` axis).

The JAX package's contract (``tests/test_sharding_equivalence.py``): a
train step on a (data, model) mesh, the backbone's block matrices split
over ``model`` by ``lavila_param_sharding``, equals the one-device step.
Here ``gloo`` processes on the CPU run the port's step with the backbone
split by ``parallel.tensor.shard_lavila`` on the bridged weights of
``tests/test_train_step.py::tiny_setup(n_videos=8)`` (visual and text
heads 4, vocabulary 64, some captions padded): four ranks as data=2 x
model=2, then two of them as model=2, each with the augmentation off and
on. Against the one-process port step and JAX's step, with
``test_sharding_equivalence``'s bounds:

- each loss term and metric within 1e-5 x max(1, |x|);
- every decoder gradient within 1e-5 x max(1, grad_norm);
- every parameter after the update within 2.1 x lr (Adam's first update
  is +-lr a weight, so a gradient at rounding noise may flip its sign).

JAX's step draws its augmentation from ``jax.random``, so with the
augmentation on it takes the port's augmented clips and boxes as its
(float) input. Also: ``spec_for_param`` against JAX's ``_spec_for_path``
on every parameter of ``init_lavila_params`` (equal but for the three
departures ``parallel/tensor.py`` names); the shards rebuild every weight
bit for bit at M = 2 and 4; the split visual and text forwards at M = 2
against the one-process forward and JAX's ``encode_image`` /
``encode_text`` (f32, within 1e-5 x max|x|); the groups in JAX's device
order; the routes at T = 128 decided on the global heads; the int8
refusal; and ``cuda`` cases of K1/K2 at the local head counts of
TimeSformer-L split over 2 and 4 ranks.
"""

import dataclasses
import os
import socket
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from helping_hand_for_egocentric_videos_torch.models import (
    DecoderConfig,
    Lavila,
    LavilaConfig,
    ObjDecoder,
    SpaceTimeConfig,
    TextConfig,
)
from helping_hand_for_egocentric_videos_torch.models import spacetime_vit as tsv
from helping_hand_for_egocentric_videos_torch.models.bridge import from_jax_params, jax_tree_to_state_dict
from helping_hand_for_egocentric_videos_torch.models.clip_text import _embed, encode_text
from helping_hand_for_egocentric_videos_torch.models.lavila import encode_image, timesformer_large_config
from helping_hand_for_egocentric_videos_torch.models.quant import quantize_lavila_params
from helping_hand_for_egocentric_videos_torch.ops.divided_attention import needs_head_grid
from helping_hand_for_egocentric_videos_torch.parallel import ModelParallel, make_groups, shard_lavila, spec_for_param
from helping_hand_for_egocentric_videos_torch.parallel.tensor import _shard
from helping_hand_for_egocentric_videos_torch.train import EvalModel, TrainConfig, TrainState, make_train_step
from helping_hand_for_egocentric_videos_torch.train.step import augment_batch

WORLD, M = 4, 2
LAYOUTS = ("data2_model2", "model2")
CASES = ("augment_off", "augment_on")
METRICS = ("total_loss", "nce_loss", "box_loss", "word_loss", "top1_video_to_text", "top1_text_to_video",
           "grad_norm")
PAD_ROWS = (3, 7, 8, 33)
# parallel/tensor.py's deliberate departures from JAX's _spec_for_path, by the
# last two parts of a parameter's name: (JAX's split dim, the port's), torch layout
DEPARTURES = {
    "mlp_fc2.weight": (0, 1),  # 1: JAX's "mlp_fc" substring test gives it the column split
    # 3: the bias of a column-split weight splits with it
    "qkv.bias": (None, 0), "mlp_fc1.bias": (None, 0), "mlp_fc.bias": (None, 0),
    "wq.bias": (None, 0), "wk.bias": (None, 0), "wv.bias": (None, 0),
}
# (2, qkv split by heads rather than in M contiguous slices, has JAX's dim:
# test_shards_rebuild_every_weight holds its cut)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fields(cls, obj, **over):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{**{k: v for k, v in dataclasses.asdict(obj).items() if k in names}, **over})


def _tcfg(base: TrainConfig, case: str) -> TrainConfig:
    if case == "augment_on":
        return dataclasses.replace(base, augment=True, input_res=28, color_jitter=(0.2, 0.2, 0.1))
    return base


def _batch(payload, case: str) -> dict:
    batch = dict(payload["batch"])
    if case == "augment_on":  # uint8 clips, boxes in the 28 x 28 frame the augmentation crops
        batch.update(video=payload["video_u8"], boxes=batch["boxes"] * 0.2)
    return batch


def _backbone(payload) -> Lavila:
    backbone = Lavila(payload["lcfg"])
    backbone.load_state_dict(payload["backbone"])
    return backbone


def _run(payload, case: str, dp=None, mpar=None):
    """One step of the port on ``payload``'s weights and batch: this data
    rank's rows and this model rank's shard, or the whole of both ->
    (metrics, gradients, parameters)."""
    tcfg = _tcfg(payload["tcfg"], case)
    backbone = _backbone(payload)
    if mpar is not None:
        backbone = shard_lavila(backbone, payload["lcfg"], mpar)
    decoder = ObjDecoder(payload["dcfg"])
    decoder.load_state_dict(payload["decoder"])
    batch = _batch(payload, case)
    if dp is not None:
        batch = {k: v[dp.rows(v.shape[0])] for k, v in batch.items()}
    state = TrainState.create(decoder, tcfg, device="cpu")
    step = make_train_step(payload["dcfg"], payload["lcfg"], tcfg, dist=dp, mp=mpar)
    state, m = step(state, backbone, batch, payload["noun_dict"], aug_generator=torch.Generator().manual_seed(11))
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.clone() for n, p in state.decoder.named_parameters() if p.grad is not None},
            {n: p.detach().clone() for n, p in state.decoder.named_parameters()})


def _forwards(payload, mpar=None):
    """The visual and text towers, f32, on the whole batch."""
    backbone = _backbone(payload)
    if mpar is not None:
        backbone = shard_lavila(backbone, payload["lcfg"], mpar)
    lcfg, batch = payload["lcfg"], payload["batch"]
    with torch.no_grad():
        image = encode_image(backbone, lcfg, batch["video"], dtype=torch.float32, mp=mpar)
        text = encode_text(backbone.text, lcfg.text, batch["tokens"].long(), mp=mpar)
    return [z.clone() for z in (*image, *text)]


def _init(rank: int, world: int, port: int):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)


def _rank_main(rank: int, ports, path: str):
    torch.set_num_threads(1)
    payload = torch.load(path, weights_only=False)
    out = {}
    _init(rank, WORLD, ports[0])
    dp, mpar = make_groups(WORLD, M, "cpu")
    out["groups"] = (dp.rank, dp.world, dist.get_process_group_ranks(dp.group), mpar.rank, mpar.size,
                     dist.get_process_group_ranks(mpar.group))
    out["data2_model2"] = {case: _run(payload, case, dp, mpar) for case in CASES}
    dist.destroy_process_group()
    if rank < M:  # the same step on one model group of two ranks
        _init(rank, M, ports[1])
        dp, mpar = make_groups(M, M, "cpu")
        out["model2"] = {case: _run(payload, case, dp, mpar) for case in CASES}
        out["forwards"] = _forwards(payload, mpar)
        dist.destroy_process_group()
    torch.save(out, f"{path}.rank{rank}")


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from test_train_step import tiny_setup

    from helping_hand_for_egocentric_videos_tpu.models import clip_text as jct
    from helping_hand_for_egocentric_videos_tpu.models import lavila as jlv
    from helping_hand_for_egocentric_videos_tpu.parallel import mesh as jmesh
    from helping_hand_for_egocentric_videos_tpu.train import step as jstep

    return types.SimpleNamespace(jax=jax, jnp=jnp, tiny_setup=tiny_setup, step=jstep, lavila=jlv, clip_text=jct,
                                 mesh=jmesh)


@pytest.fixture(scope="module")
def setup(jx):
    """The bridged tiny setup as a payload the ranks load, and JAX's trees."""
    jl, jd, jt, jbackbone, jdecoder, jbatch, jnoun = jx.tiny_setup(n_videos=8)
    batch = {k: np.array(v) for k, v in jbatch.items()}
    batch["tokens"][list(PAD_ROWS), 1:] = 0
    batch["tokens"][list(PAD_ROWS), 1] = 63
    lcfg = LavilaConfig(visual=_fields(SpaceTimeConfig, jl.visual, attention_backend="kernel"),
                        text=_fields(TextConfig, jl.text), embed_dim=jl.embed_dim)
    dcfg = DecoderConfig(**dataclasses.asdict(jd))
    tcfg = _fields(TrainConfig, jt, backbone_dtype=torch.float32)
    backbone, decoder = from_jax_params(jbackbone, jdecoder, lcfg, dcfg)
    rng = np.random.default_rng(9)
    payload = {
        "lcfg": lcfg, "dcfg": dcfg, "tcfg": tcfg, "backbone": backbone.state_dict(),
        "decoder": decoder.state_dict(), "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
        "video_u8": torch.from_numpy(rng.integers(0, 256, size=(8, 2, 40, 56, 3), dtype=np.uint8)),
        "noun_dict": torch.from_numpy(np.array(jnoun)),
    }
    return types.SimpleNamespace(payload=payload, jax=(jl, jd, jt, jbackbone, jdecoder, batch, jnoun))


@pytest.fixture(scope="module")
def runs(jx, setup, tmp_path_factory):
    """Every rank's runs, the one-process port runs and JAX's steps."""
    path = str(tmp_path_factory.mktemp("tp") / "payload.pt")
    torch.save(setup.payload, path)
    mp.start_processes(_rank_main, args=((_free_port(), _free_port()), path), nprocs=WORLD, start_method="spawn")
    ranks = [torch.load(f"{path}.rank{r}", weights_only=False) for r in range(WORLD)]
    one = {case: _run(setup.payload, case) for case in CASES}

    jl, jd, jt, jbackbone, jdecoder, batch, jnoun = setup.jax
    jnp = jx.jnp
    opt = jx.step.make_optimizer(jt)
    state = jx.step.TrainState(jdecoder, opt.init(jdecoder), jnp.zeros((), jnp.int32))
    step = jx.jax.jit(jx.step.make_train_step(jd, jl, jt, opt, debug_grads=True))
    jax_runs = {}
    for case in CASES:
        inputs = dict(batch)
        if case == "augment_on":  # the port's augmented clips and boxes, drawn as _run draws them
            video, boxes = augment_batch(_tcfg(setup.payload["tcfg"], case), setup.payload["video_u8"],
                                         setup.payload["batch"]["boxes"] * 0.2, torch.Generator().manual_seed(11))
            inputs.update(video=video.numpy(), boxes=boxes.numpy())
        new, m = step(state, jbackbone, {k: jnp.asarray(v) for k, v in inputs.items()}, jnoun, None)
        jax_runs[case] = ({k: float(m[k]) for k in METRICS}, jax_tree_to_state_dict(m["grads"]),
                          jax_tree_to_state_dict(new.params))
    return types.SimpleNamespace(one=one, ranks=ranks, jax=jax_runs, lr=setup.payload["tcfg"].lr)


def _ranks_of(layout: str):
    return range(WORLD) if layout == "data2_model2" else range(M)


def _close(got: dict, want: dict, lr: float, grad_norm: float):
    m, g, p = got
    wm, wg, wp = want
    for k in METRICS:
        assert abs(m[k] - wm[k]) <= 1e-5 * max(1.0, abs(wm[k])), (k, m[k], wm[k])
    # JAX's gradient tree also holds the frozen class_embed / vid_proj, which
    # the loss never reads; the port leaves their .grad unset
    assert set(g) <= set(wg) and {n.split(".")[0] for n in set(wg) - set(g)} <= {"class_embed", "vid_proj"}
    for name, x in g.items():
        assert float((x - wg[name]).abs().max()) <= 1e-5 * max(1.0, grad_norm), name
    for name, w in wp.items():
        assert float((p[name] - w).abs().max()) <= 2.1 * lr, name


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_split_step_equals_the_one_process_step(runs, layout, case):
    want = runs.one[case]
    assert want[0]["box_loss"] > 0 and want[0]["word_loss"] > 0  # every term is exercised
    for rank in _ranks_of(layout):
        _close(runs.ranks[rank][layout][case], want, runs.lr, want[0]["grad_norm"])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_split_step_equals_the_jax_step(runs, layout, case):
    want = runs.jax[case]
    for rank in _ranks_of(layout):
        _close(runs.ranks[rank][layout][case], want, runs.lr, want[0]["grad_norm"])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_model_ranks_keep_one_decoder(runs, layout):
    """The ranks of a model group end the step with the same parameters
    (their gradients are averaged over the group)."""
    for case in CASES:
        for rank in _ranks_of(layout):
            peer = rank ^ 1  # the other rank of its model group
            for name, p in runs.ranks[rank][layout][case][2].items():
                assert torch.equal(p, runs.ranks[peer][layout][case][2][name]), (case, rank, name)


def test_groups_follow_the_jax_mesh_order(runs):
    """Model index = rank % M, data index = rank // M (``make_mesh``)."""
    for rank in range(WORLD):
        d_rank, d_world, d_ranks, m_rank, m_size, m_ranks = runs.ranks[rank]["groups"]
        assert (d_rank, d_world, m_rank, m_size) == (rank // M, WORLD // M, rank % M, M)
        assert d_ranks == list(range(rank % M, WORLD, M))
        assert m_ranks == list(range(rank // M * M, rank // M * M + M))


def test_split_forwards_equal_one_process_and_jax(jx, setup, runs):
    """The visual tower (CLS projected, token map) and the text tower
    (embedding, feature map) split over two ranks, f32."""
    jl, _, _, jbackbone, _, batch, _ = setup.jax
    jnp = jx.jnp
    j_image = jx.lavila.encode_image(jbackbone, jl, jnp.asarray(batch["video"]), dtype=jnp.float32)
    j_text = jx.clip_text.encode_text(jbackbone["text"], jl.text, jnp.asarray(batch["tokens"]))
    want_jax = [np.asarray(z) for z in (*j_image, *j_text)]
    want_one = [z.numpy() for z in _forwards(setup.payload)]
    for rank in range(M):
        for got, one, jz in zip(runs.ranks[rank]["forwards"], want_one, want_jax):
            got = got.numpy()
            assert got.shape == jz.shape
            for want in (one, jz):
                tol = 1e-5 * float(np.abs(want).max())
                np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _torch_dim(spec, keys, ndim: int):
    """JAX's split dim of a leaf -> the dim of its torch tensor, or None."""
    axes = list(spec) + [None] * (ndim - len(spec))
    if "model" not in axes:
        return None
    i = axes.index("model")
    if "blocks" in keys:
        i -= 1  # the stacked layer dim
    return 1 - i if keys[-1] == "w" else i  # a Linear's (in, out) is torch's (out, in)


def _torch_names(keys, shape):
    *mods, last = keys
    param = {"w": "weight", "b": "bias", "g": "weight"}.get(last, last)
    if "blocks" not in mods:
        return [".".join([*mods, param])]
    i = mods.index("blocks")
    return [".".join([*mods[:i + 1], str(layer), *mods[i + 1:], param]) for layer in range(shape[0])]


def test_spec_for_param_is_jax_rule_but_the_named_departures(jx, setup):
    tree = setup.jax[3]
    names, differ = set(), {}
    for path, leaf in jx.jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        want = _torch_dim(jx.mesh._spec_for_path("/".join(keys), np.shape(leaf)), keys, np.ndim(leaf))
        for name in _torch_names(keys, np.shape(leaf)):
            names.add(name)
            if spec_for_param(name) != want:
                differ[name] = (want, spec_for_param(name))
    assert names == set(jax_tree_to_state_dict(tree)) == set(setup.payload["backbone"])
    by_kind = {".".join(n.split(".")[-2:]): v for n, v in differ.items()}
    assert by_kind == DEPARTURES
    # in every block: visual mlp_fc2 and the two qkv and the mlp_fc1 biases,
    # text the wq/wk/wv and mlp_fc biases; 2 blocks a tower
    assert len(differ) == 2 * 4 + 2 * 4
    assert spec_for_param("text.token_embedding") == 0 and spec_for_param("visual.blocks.0.attn.qkv.weight") == 0


@pytest.mark.parametrize("size", [2, 4])
def test_shards_rebuild_every_weight(setup, size):
    full = _backbone(setup.payload)
    before = {k: v.clone() for k, v in full.state_dict().items()}
    lcfg = setup.payload["lcfg"]
    shards = [dict(shard_lavila(full, lcfg, ModelParallel(r, size)).named_parameters()) for r in range(size)]
    for name, p in full.named_parameters():
        parts = [s[name].detach() for s in shards]
        dim = spec_for_param(name)
        if dim is None:
            assert all(torch.equal(x, p) for x in parts), name
            continue
        assert all(x.shape[dim] * size == p.shape[dim] for x in parts), name
        if name.endswith(("qkv.weight", "qkv.bias")):  # rank r: its heads of q, then of k, then of v
            rebuilt = torch.cat([torch.cat([x.chunk(3)[i] for x in parts]) for i in range(3)])
        else:
            rebuilt = torch.cat(parts, dim)
        assert torch.equal(rebuilt, p.detach()), name
    assert all(torch.equal(v, full.state_dict()[k]) for k, v in before.items())  # the full module is untouched


class _Sum:
    """A stand-in model group in one process: ``all_reduce`` leaves its
    input as it is, so the ranks' partial results can be summed by hand."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size

    def all_reduce(self, x):
        return x


@pytest.mark.parametrize("size", [2, 3, 4])
def test_vocab_split_lookup_sums_to_the_lookup(size):
    """``token_embedding`` over ranks, an uneven cut too (64 rows over 3)."""
    table = torch.randn(64, 8, generator=torch.Generator().manual_seed(0))
    tokens = torch.tensor([[0, 1, 21, 22, 42, 43, 63], [5, 30, 31, 50, 2, 63, 0]])
    total = sum(_embed(_shard_rows(table, r, size), tokens, 64, _Sum(r, size)) for r in range(size))
    assert torch.equal(total, table[tokens])


def _shard_rows(table, rank, size):
    return _shard("text.token_embedding", table, 0, ModelParallel(rank, size))


def test_routes_at_long_clips_are_decided_on_global_heads(monkeypatch):
    """TimeSformer-L at T = 128 over two ranks takes the one-card routes:
    time attention on K6 and out of the JAX package's int8 fusion, though
    8 local heads alone would pass ``needs_head_grid`` (the TPU budget)."""
    cfg = timesformer_large_config(num_frames=128).visual
    one = tsv.block_routes(cfg, 128, 256)
    two = tsv.block_routes(cfg, 128, 256, ModelParallel(0, 2))
    assert needs_head_grid(128, 256, 16) and not needs_head_grid(128, 256, 8)
    assert one["head_grid"] and two["head_grid"]
    assert one["kernel_friendly"] == two["kernel_friendly"] == {"time": False, "space": True}
    assert (one["heads"], two["heads"]) == (16, 8)

    # the split forward launches on 8 heads with those routes: a 1-block
    # tower whose 16 heads hit the same threshold at N = 9 patches
    small = SpaceTimeConfig(img_size=42, patch_size=14, width=32, depth=1, heads=16, num_frames=128)
    assert needs_head_grid(128, 9, 16) and not needs_head_grid(128, 9, 8)
    calls, real = [], tsv.divided_patch_attention

    def record(*args, **kw):
        calls.append((kw["mode"], kw["heads"], kw.get("head_grid")))
        return real(*args, **kw)

    monkeypatch.setattr(tsv, "divided_patch_attention", record)
    lcfg = LavilaConfig(visual=small, text=TextConfig(vocab_size=64, context_length=4, width=16, heads=2, layers=1))
    tower = shard_lavila(Lavila(lcfg), lcfg, ModelParallel(0, 2)).visual
    video = torch.randn(1, 128, 42, 42, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        tsv.spacetime_forward(tower, small, video, dtype=torch.float32, mp=_Sum(0, 2))
    assert calls == [("time", 8, True), ("space", 8, None)]


def test_int8_backbone_with_model_parallel_raises(setup):
    q = quantize_lavila_params(_backbone(setup.payload))
    with pytest.raises(ValueError, match="int8 backbone.*K3 and K5"):
        shard_lavila(q, setup.payload["lcfg"], ModelParallel(0, 2))
    p = setup.payload
    with pytest.raises(ValueError, match="int8 tower does not split"):
        EvalModel(_backbone(p), p["lcfg"], ObjDecoder(p["dcfg"]), p["dcfg"], None, device="cpu", int8=True,
                  mp=ModelParallel(0, 2))


def test_groups_that_do_not_split_the_world_raise():
    with pytest.raises(ValueError, match="does not divide"):
        make_groups(3, 2, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [8, 4])
@pytest.mark.parametrize("b, t", [(16, 4), (8, 16)])
@pytest.mark.parametrize("mode", ["space", "time"])
def test_cuda_kernels_on_local_heads(mode, b, t, heads):
    """K1/K2 at TimeSformer-L's local head counts over 2 and 4 ranks (N =
    256, dh = 64), bf16 and f32, against their plain versions: the patch
    output and the merged CLS output (f32 atol 1e-4, bf16 2e-2, as
    ``chip_smoke.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python -m pytest --noconftest -m cuda tests/test_torch_tensor_parallel.py)")
    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    gen = torch.Generator(device="cuda").manual_seed(0)
    d = heads * 64
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        qkv = torch.randn(b, t, 256, 3 * d, generator=gen, device="cuda").to(dtype)
        ck, cv, cq = (torch.randn(b, d, generator=gen, device="cuda").to(dtype) for _ in range(3))
        out, parts = da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=heads)
        cls = da.merge_cls_partials(*parts, cq, ck, cv, heads)
        f32 = [z.float() for z in (qkv, ck, cv, cq)]
        ref, ref_parts = da.divided_patch_attention_ref(*f32, mode=mode, heads=heads)
        ref_cls = da.merge_cls_partials(*ref_parts, f32[3], f32[1], f32[2], heads)
        torch.cuda.synchronize()
        assert float((out.float() - ref).abs().max()) <= tol
        assert float((cls - ref_cls).abs().max()) <= tol


@pytest.mark.parametrize("tower", ["visual", "text"])
def test_heads_that_do_not_split_raise(setup, tower):
    """Each rank runs whole heads: a width that splits over 2 ranks with 3
    heads in one tower is refused before any weight is cut."""
    lcfg = setup.payload["lcfg"]
    lcfg = dataclasses.replace(lcfg, **{tower: dataclasses.replace(getattr(lcfg, tower), heads=3)})
    with pytest.raises(ValueError, match=f"the {tower} tower's 3 heads do not split over 2 ranks"):
        shard_lavila(_backbone(setup.payload), lcfg, ModelParallel(0, 2))
