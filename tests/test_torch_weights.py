"""The port's checkpoint converters against the JAX package's.

The synthetic state dicts of ``tests/test_weights.py`` (the reference's key
layout) go through both packages' converters; the JAX trees, carried into
the port's modules by ``models/bridge.py``, must hold exactly the tensors
the port's converters produce. ``inflate_temporal_embed`` is held against
the JAX one, ``load_torch_state_dict`` against the checkpoint forms the
reference writes.
"""

import types
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from helping_hand_for_egocentric_videos_tpu.models import weights as jw
from helping_hand_for_egocentric_videos_torch.core.config import ExperimentConfig
from helping_hand_for_egocentric_videos_torch.data import ClipTokenizer
from helping_hand_for_egocentric_videos_torch.models import weights as tw
from helping_hand_for_egocentric_videos_torch.models.bridge import lavila_from_jax, load_jax_params
from helping_hand_for_egocentric_videos_torch.models.clip_text import TextConfig, encode_text
from helping_hand_for_egocentric_videos_torch.models.lavila import (
    Lavila,
    LavilaConfig,
    lavila_forward,
    timesformer_tiny_config,
)
from helping_hand_for_egocentric_videos_torch.models.obj_decoder import DecoderConfig, ObjDecoder
from helping_hand_for_egocentric_videos_torch.models.spacetime_vit import SpaceTimeConfig, patchify
from helping_hand_for_egocentric_videos_torch.train.evaluate import EvalModel
from helping_hand_for_egocentric_videos_torch.train.pretrain import build_models
from test_torch_clip_image import openai_clip_sd
from test_weights import make_decoder_sd, make_lavila_sd

LCFG = LavilaConfig(
    visual=SpaceTimeConfig(img_size=28, patch_size=14, width=32, depth=2, heads=4, num_frames=2),
    text=TextConfig(vocab_size=64, context_length=12, width=32, heads=4, layers=2, embed_dim=16),
    embed_dim=16,
)
DCFG = DecoderConfig(
    d_model=32, nhead=4, num_layers=2, dim_feedforward=64, num_queries=5, num_classes=10,
    feature_dim=48, text_width=24, embed_dim=16, num_frames=2, patches_per_frame=4, pred_traj=False,
)


def _torch_sd(sd):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}


def _assert_same_state(got: torch.nn.Module, want: torch.nn.Module):
    a, b = got.state_dict(), want.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == torch.float32 and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def test_lavila_conversion_equals_jax_bridged():
    sd = make_lavila_sd()
    got = tw.convert_lavila_checkpoint(_torch_sd(sd), LCFG)
    want = load_jax_params(Lavila(LCFG), jax.tree.map(np.asarray, jw.convert_lavila_checkpoint(sd, 2, 2)))
    _assert_same_state(got, want)
    assert not any(p.is_meta for p in got.parameters())


def test_decoder_conversion_equals_jax_bridged():
    """The checkpoint's trajectory head is kept (as JAX keeps it) though
    this eval config has ``pred_traj=False``."""
    sd = make_decoder_sd()
    got = tw.convert_decoder_checkpoint(_torch_sd(sd), DCFG)
    want = load_jax_params(ObjDecoder(replace(DCFG, pred_traj=True)),
                           jax.tree.map(np.asarray, jw.convert_decoder_checkpoint(sd, num_layers=2)))
    _assert_same_state(got, want)


def test_patch_embedding_is_the_reference_conv():
    """The (D, C, P, P) conv becomes the flat channel-last Linear of
    ``patchify``: the same patch tokens as the reference's stride-P conv."""
    sd = make_lavila_sd()
    model = tw.convert_lavila_checkpoint(_torch_sd(sd), LCFG)
    video = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 2, 28, 28, 3)).astype(np.float32))
    got = patchify(model.visual, LCFG.visual, video)
    conv = torch.nn.functional.conv2d(video[:, 0].permute(0, 3, 1, 2),
                                      torch.as_tensor(sd["visual.patch_embed.proj.weight"]), stride=14)
    torch.testing.assert_close(got[:, :4], conv.flatten(2).transpose(1, 2), rtol=0, atol=1e-5)


@pytest.mark.parametrize("t0, t", [(4, 16), (4, 128), (16, 4), (16, 16)])
def test_inflate_temporal_embed_matches_jax(t0, t):
    te = np.random.default_rng(t0 * 1000 + t).normal(size=(1, t0, 24)).astype(np.float32)
    got = tw.inflate_temporal_embed(torch.from_numpy(te), t)
    assert got.shape == (1, t, 24) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(jw.inflate_temporal_embed(te, t)), atol=1e-6)


@pytest.mark.parametrize("form", ["module_prefix", "inner_state_dict", "bare"])
def test_load_torch_state_dict_forms(tmp_path, form):
    """A DataParallel ``module.`` prefix is stripped; a ``{"state_dict":
    ...}`` checkpoint (the decoder's ``.pth.tar``) is unwrapped; a bare
    state dict is taken as it is; values come back as f32 tensors."""
    sd = {"lin.weight": torch.randn(2, 4, dtype=torch.float64), "lin.bias": torch.zeros(2)}
    path = tmp_path / "ckpt.pth"
    obj = {"module_prefix": {f"module.{k}": v for k, v in sd.items()},
           "inner_state_dict": {"state_dict": sd, "epoch": 3, "args": {"lr": 1e-4}},
           "bare": sd}[form]
    torch.save(obj, path)
    got = tw.load_torch_state_dict(str(path))
    assert set(got) == set(sd)
    assert all(v.dtype == torch.float32 for v in got.values())
    for k, v in sd.items():
        torch.testing.assert_close(got[k], v.float(), rtol=0, atol=0)


def test_load_torch_state_dict_torchscript_archive(tmp_path):
    """The official OpenAI CLIP releases are TorchScript archives: the
    ScriptModule's state dict is taken, as the JAX loader takes it."""
    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(4, 2)
            self.register_buffer("scale", torch.arange(3, dtype=torch.float64))

        def forward(self, x):
            return self.lin(x)

    path = tmp_path / "scripted.pt"
    torch.jit.save(torch.jit.script(M()), str(path))
    got, want = tw.load_torch_state_dict(str(path)), jw.load_torch_state_dict(str(path))
    assert set(got) == set(want) == {"lin.weight", "lin.bias", "scale"}
    for k in got:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k])


_TEXT_KEYS = ("token_embedding.", "positional_embedding", "transformer.", "ln_final.", "text_projection")


@pytest.mark.parametrize("heads", ["projections", "bare"])
def test_vision_only_checkpoint_equals_jax(heads):
    """A checkpoint without the text tower (and, "bare", without the
    projections and logit scale: a SpaceTimeTransformer's) converts what is
    present, as JAX does; the video side embeds, the text side refuses."""
    drop = _TEXT_KEYS + (("image_projection", "logit_scale") if heads == "bare" else ())
    sd = {k: v for k, v in make_lavila_sd().items() if not k.startswith(drop)}
    got = tw.convert_lavila_checkpoint(_torch_sd(sd), LCFG)
    tree = jax.tree.map(np.asarray, jw.convert_lavila_checkpoint(sd, 2, 2))
    assert "text" not in tree and got.text is None
    _assert_same_state(got, lavila_from_jax(tree, LCFG))
    assert (got.image_projection is None) == (heads == "bare") == (got.logit_scale is None)

    dcfg = replace(DCFG, feature_dim=32)
    model = EvalModel(got, LCFG, ObjDecoder(dcfg), dcfg, ClipTokenizer(), input_res=28, dtype=torch.float32,
                      device="cpu")
    clips = np.random.default_rng(1).integers(0, 256, size=(2, 2, 28, 28, 3), dtype=np.uint8)
    emb, boxes = model.embed_video(clips)
    assert emb.shape == (2, dcfg.embed_dim) and np.isfinite(emb).all() and np.isfinite(boxes).all()
    tokens = torch.zeros(1, 12, dtype=torch.long)
    with pytest.raises(ValueError, match="no text tower"):
        model.embed_text(["#C C opens the fridge"])
    with pytest.raises(ValueError, match="no text tower"):
        model.embed_tokens(tokens.numpy())
    with pytest.raises(ValueError, match="no text tower"):
        encode_text(got.text, LCFG.text, tokens)
    video = torch.zeros(1, 2, 28, 28, 3)
    with pytest.raises(ValueError, match="no text tower" if heads == "projections" else "no image_projection"):
        lavila_forward(got, LCFG, video, tokens, dtype=torch.float32)


TINY_CLIP = dict(vit=dict(input_resolution=224, patch_size=32, width=128, layers=2, heads=2, output_dim=512),
                 text_width=64, text_layers=2, vocab=49408, context=77, embed_dim=64)


def _stock_clip_sd(seed=5, **over):
    """A stock OpenAI CLIP ViT state dict at timesformer_tiny's shapes
    (numpy, the reference's key layout)."""
    return openai_clip_sd(np.random.default_rng(seed), "vit", **{**TINY_CLIP, **over})


@pytest.mark.parametrize("embed_dim", [256, 64], ids=["projections-drawn", "text-projection-kept"])
def test_openai_clip_bootstrap_equals_jax(embed_dim):
    """``convert_openai_clip_checkpoint`` gives JAX's weights exactly, the
    projections drawn from the same numpy generator (both at 256; at 64 the
    text projection is CLIP's and only the image one is drawn)."""
    sd = _stock_clip_sd()
    got = tw.convert_openai_clip_checkpoint(_torch_sd(sd), num_frames=4, project_embed_dim=embed_dim, seed=3)
    tree = jax.tree.map(np.asarray, jw.convert_openai_clip_checkpoint(sd, 4, embed_dim, seed=3))
    assert len(got.visual.blocks) == len(got.text.blocks) == 2
    assert got.visual.patch_embed.weight.shape == (128, 32 * 32 * 3) and got.image_projection.shape == (128, embed_dim)
    _assert_same_state(got, lavila_from_jax(tree, timesformer_tiny_config(num_frames=4, project_embed_dim=embed_dim)))
    if embed_dim == 64:
        np.testing.assert_array_equal(got.text.text_projection.detach().numpy(), sd["text_projection"])
    # time_init='zeros': time attention is an identity residual at the start
    for blk in got.visual.blocks:
        assert not blk.timeattn.qkv.weight.any() and not blk.timeattn.qkv.bias.any()
        assert (blk.timeattn.proj.weight == 1).all() and not blk.timeattn.proj.bias.any()
        assert (blk.norm3.weight == 1).all() and not blk.norm3.bias.any()
    assert got.visual.temporal_embed.shape == (1, 4, 128) and not got.visual.temporal_embed.any()


def test_openai_clip_bootstrap_refuses_other_shapes():
    sd = _torch_sd(_stock_clip_sd())
    lcfg = timesformer_tiny_config(num_frames=4, project_embed_dim=256)
    got = tw.convert_openai_clip_checkpoint(sd, 4, 256, cfg=lcfg)
    assert got.visual.blocks[0].attn.qkv.weight.shape == (384, 128)
    with pytest.raises(ValueError, match="2 visual blocks and 2 text layers, the config 24 and 2"):
        tw.convert_openai_clip_checkpoint(sd, 4, 256, cfg=replace(lcfg, visual=replace(lcfg.visual, depth=24)))
    with pytest.raises(RuntimeError, match="size mismatch"):  # any other shape: the strict load
        tw.convert_openai_clip_checkpoint(sd, 4, 256, cfg=timesformer_tiny_config(num_frames=4, project_embed_dim=64))


@pytest.fixture(scope="module")
def bootstrapped(tmp_path_factory):
    """``build_models`` of both packages on a stock CLIP file (torch.save
    of its state dict), timesformer_tiny, 4 frames, f32 backbone."""
    from helping_hand_for_egocentric_videos_tpu.core.config import ExperimentConfig as JExperimentConfig
    from helping_hand_for_egocentric_videos_tpu.train import pretrain as jpre

    path = tmp_path_factory.mktemp("clip") / "ViT-tiny.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in _stock_clip_sd().items()}, path)
    cfgs = []
    for cls in (JExperimentConfig, ExperimentConfig):
        cfg = cls()
        cfg.model.backbone, cfg.model.backbone_ckpt = "timesformer_tiny", str(path)
        cfg.parallel.backbone_dtype = "float32"
        cfgs.append(cfg)
    return types.SimpleNamespace(jax=jpre.build_models(cfgs[0]), port=build_models(cfgs[1]), jpre=jpre, cfgs=cfgs)


def test_build_models_bootstraps_a_stock_clip_checkpoint(bootstrapped):
    """A stock CLIP ``backbone_ckpt`` bootstraps the TimeSformer (it used
    to raise): the backbone equals JAX's ``build_models``' exactly."""
    jl, jbackbone, _, _ = bootstrapped.jax
    lcfg, backbone, dcfg, _ = bootstrapped.port
    assert lcfg == timesformer_tiny_config(num_frames=4, project_embed_dim=256)
    assert backbone.visual.temporal_embed.shape == (1, 4, 128)
    _assert_same_state(backbone, load_jax_params(Lavila(lcfg), jax.tree.map(np.asarray, jbackbone)))


def test_train_step_from_a_stock_clip_checkpoint_matches_jax(bootstrapped):
    """One train step on the bootstrapped backbone (its time attention all
    zero) and JAX's decoder: the losses within 1e-5."""
    import jax.numpy as jnp

    from helping_hand_for_egocentric_videos_tpu.train import step as jstep
    from helping_hand_for_egocentric_videos_torch.train import TrainState, make_train_step
    from helping_hand_for_egocentric_videos_torch.train.pretrain import build_train_config

    jl, jbackbone, jd, jdecoder = bootstrapped.jax
    lcfg, backbone, dcfg, _ = bootstrapped.port
    jt = bootstrapped.jpre.build_train_config(bootstrapped.cfgs[0])
    tcfg = build_train_config(bootstrapped.cfgs[1])
    rng = np.random.default_rng(0)
    b, t, r = 2, 4, tcfg.rephrase_factor
    tokens = np.zeros((b * r, 77), np.int32)
    tokens[:, 0] = 49406
    tokens[:, 1:4] = rng.integers(1, 49000, size=(b * r, 3))
    tokens[:, 4] = 49407
    boxes = (rng.random((b, t, 4, 4)) * 150).astype(np.float32)
    boxes[..., 2:] += 40
    batch = {"video": rng.normal(size=(b, t, 224, 224, 3)).astype(np.float32), "tokens": tokens,
             "noun_vec": (rng.random((b, 20)) < 0.3).astype(np.float32),
             "verb_vec": (rng.random((b, 10)) < 0.3).astype(np.float32), "boxes": boxes,
             "nouns": rng.integers(0, 30, size=(b, 4)).astype(np.int32)}
    noun_dict = rng.normal(size=(30, 64)).astype(np.float32)

    opt = jstep.make_optimizer(jt)
    jstate = jstep.TrainState(jdecoder, opt.init(jdecoder), jnp.zeros((), jnp.int32))
    _, jm = jstep.make_train_step(jd, jl, jt, opt)(
        jstate, jbackbone, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(noun_dict), None)
    decoder = load_jax_params(ObjDecoder(dcfg), jax.tree.map(np.asarray, jdecoder))
    state = TrainState.create(decoder, tcfg, device="cpu")
    _, tm = make_train_step(dcfg, lcfg, tcfg)(state, backbone, batch, noun_dict)
    for k in ("total_loss", "nce_loss", "box_loss", "word_loss"):
        assert np.isfinite(float(tm[k])), k
        assert float(tm[k]) == pytest.approx(float(jm[k]), abs=1e-5), k
