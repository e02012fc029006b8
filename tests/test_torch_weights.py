"""The port's checkpoint converters against the JAX package's.

The synthetic state dicts of ``tests/test_weights.py`` (the reference's key
layout) go through both packages' converters; the JAX trees, carried into
the port's modules by ``models/bridge.py``, must hold exactly the tensors
the port's converters produce. ``inflate_temporal_embed`` is held against
the JAX one, ``load_torch_state_dict`` against the checkpoint forms the
reference writes.
"""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from helping_hand_for_egocentric_videos_tpu.models import weights as jw
from helping_hand_for_egocentric_videos_torch.core.config import ExperimentConfig
from helping_hand_for_egocentric_videos_torch.models import weights as tw
from helping_hand_for_egocentric_videos_torch.models.bridge import load_jax_params
from helping_hand_for_egocentric_videos_torch.models.clip_text import TextConfig
from helping_hand_for_egocentric_videos_torch.models.lavila import Lavila, LavilaConfig
from helping_hand_for_egocentric_videos_torch.models.obj_decoder import DecoderConfig, ObjDecoder
from helping_hand_for_egocentric_videos_torch.models.spacetime_vit import SpaceTimeConfig, patchify
from helping_hand_for_egocentric_videos_torch.train.pretrain import build_models
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


def test_build_models_refuses_a_stock_clip_checkpoint(tmp_path):
    path = tmp_path / "clip.pt"
    torch.save({"visual.class_embedding": torch.zeros(8)}, path)
    cfg = ExperimentConfig()
    cfg.model.backbone, cfg.model.backbone_ckpt = "timesformer_tiny", str(path)
    with pytest.raises(NotImplementedError, match="convert_openai_clip_checkpoint"):
        build_models(cfg)
