"""The port's visualisation path against the JAX package's, on the CPU.

- ``decoder_forward(..., return_attn=True)``: every layer's head-averaged
  cross- and self-attention maps (f32, 1e-5), the boxes unchanged by the
  flag, each map's rows summing to 1;
- ``position_embedding_sine`` with ``normalize`` off, on, and with a
  ``scale`` (1e-6), and its ``ValueError``;
- ``utils/path_vis.py``: equal arrays;
- ``cli.visualize.main`` of both packages at timesformer_tiny (4 frames,
  the 13-query decoder with its trajectory head) from the same
  reference-layout checkpoint files (tests/test_torch_cli.py's ``_ckpts``)
  on a synthetic 256 x 342 ``.npy`` clip with ``--attn``: both in f32
  (each package's ``EvalModel`` and the ``--attn`` forward), ``boxes.png``
  and ``cross_attn.png`` within 1 level (the display frames' antialiased
  bilinear resize differs by ~1e-3 between the frameworks before
  ``astype(uint8)`` truncates it).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from helping_hand_for_egocentric_videos_tpu.cli import visualize as j_visualize
from helping_hand_for_egocentric_videos_tpu.models import lavila as j_lavila
from helping_hand_for_egocentric_videos_tpu.models import obj_decoder as jod
from helping_hand_for_egocentric_videos_tpu.train import evaluate as jev
from helping_hand_for_egocentric_videos_tpu.utils import path_vis as j_path_vis
from helping_hand_for_egocentric_videos_torch.cli import visualize
from helping_hand_for_egocentric_videos_torch.models import obj_decoder as tod
from helping_hand_for_egocentric_videos_torch.models.bridge import load_jax_params
from helping_hand_for_egocentric_videos_torch.train import evaluate as tev
from helping_hand_for_egocentric_videos_torch.utils import path_vis
import test_weights
from test_torch_cli import _ckpts

ATOL = 1e-5
SMALL = dict(
    d_model=32, nhead=4, num_layers=3, dim_feedforward=64, num_classes=6,
    feature_dim=48, text_width=40, embed_dim=16, num_frames=3, patches_per_frame=4,
)


@pytest.mark.parametrize("num_queries, pred_traj", [(5, True), (5, False), (1, True)])
def test_decoder_attention_maps_match_jax(rng, num_queries, pred_traj):
    kw = dict(SMALL, num_queries=num_queries, pred_traj=pred_traj, n_decode=4)
    params = jax.tree.map(np.asarray, jod.init_decoder_params(jax.random.PRNGKey(9), jod.DecoderConfig(**kw)))
    feats = rng.normal(size=(2, 3, 4, 48)).astype(np.float32)
    want = jod.decoder_forward(params, jod.DecoderConfig(**kw), jnp.asarray(feats), return_attn=True)
    cfg = tod.DecoderConfig(**kw)
    dec = load_jax_params(tod.ObjDecoder(cfg), params)
    with torch.inference_mode():
        got = tod.decoder_forward(dec, cfg, torch.from_numpy(feats), return_attn=True)
        plain = tod.decoder_forward(dec, cfg, torch.from_numpy(feats))
    assert got.cross_attn.shape == (3, 2, num_queries, 12) and got.self_attn.shape == (3, 2, num_queries, num_queries)
    assert plain.cross_attn is None and plain.self_attn is None
    for k in ("cross_attn", "self_attn"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)), atol=ATOL, err_msg=k)
        np.testing.assert_allclose(getattr(got, k).sum(-1).numpy(), 1.0, atol=1e-5)
    torch.testing.assert_close(got.pred_boxes, plain.pred_boxes, rtol=0, atol=0)


@pytest.mark.parametrize("normalize, scale", [(False, None), (True, None), (True, 3.0)],
                         ids=["plain", "normalize", "scale"])
def test_position_embedding_sine_matches_jax(normalize, scale):
    mask = np.zeros((2, 5, 7), bool)
    mask[0, 3:, :] = True
    mask[1, :, 5:] = True
    want = np.asarray(jod.position_embedding_sine(jnp.asarray(mask), num_pos_feats=8, normalize=normalize,
                                                  scale=scale))
    got = tod.position_embedding_sine(torch.from_numpy(mask), num_pos_feats=8, normalize=normalize, scale=scale)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 16, 5, 7)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_position_embedding_sine_refuses_scale_without_normalize():
    with pytest.raises(ValueError, match="normalize should be True"):
        tod.position_embedding_sine(torch.zeros(1, 2, 2, dtype=torch.bool), scale=1.0)


def test_path_vis_equals_jax():
    window = np.zeros((4, 6), np.float32)
    window[:, 4:] = np.nan
    target = [(2, 0), (2, 1), (5, 3), (7, 4)]
    pred = [(2, 0), (5, 2), (7, 4), (9, 1)]  # (9, 1): a row with no target cell, skipped
    got = path_vis.visualise_path(pred, target, window)
    want = j_path_vis.visualise_path(pred, target, window)
    assert got.shape == (3, 4, 6)
    np.testing.assert_array_equal(got, want)
    preds = {"dtw": pred, "min_dist": [(5, 3)]}
    np.testing.assert_array_equal(path_vis.batch_path_vis(preds, target, window),
                                  j_path_vis.batch_path_vis(preds, target, window))


@pytest.mark.parametrize("shape", [(4, 256, 342), (4, 96, 128)], ids=["down", "up"])
def test_display_frames_match_jax_resize(shape):
    frames = np.random.default_rng(3).integers(0, 256, size=(*shape, 3), dtype=np.uint8)
    want = np.asarray(jax.image.resize(jnp.asarray(frames).astype(np.float32), (4, 224, 224, 3), "bilinear"))
    got = visualize.display_frames(frames, 224)
    assert got.dtype == np.uint8 and got.shape == (4, 224, 224, 3)
    assert np.abs(got.astype(int) - want.astype(np.uint8).astype(int)).max() <= 1


@pytest.fixture
def f32_both(monkeypatch):
    monkeypatch.setenv("HH_COMPILATION_CACHE", "0")
    monkeypatch.setattr(jev, "EvalModel", functools.partial(jev.EvalModel, dtype=jnp.float32))
    monkeypatch.setattr(tev, "EvalModel", functools.partial(tev.EvalModel, dtype=torch.float32))
    monkeypatch.setattr(j_lavila, "encode_image", functools.partial(j_lavila.encode_image, dtype=jnp.float32))
    monkeypatch.setattr(visualize, "cross_attention_maps",
                        functools.partial(visualize.cross_attention_maps, dtype=torch.float32))


def test_visualize_cli_matches_jax(tmp_path, f32_both, monkeypatch):
    # the checkpoints draw from test_weights' shared generator: a fresh one
    # gives the weights this file sees alone, whatever ran before it
    monkeypatch.setattr(test_weights, "R", np.random.default_rng(3))
    bpath, dpath = _ckpts(tmp_path)
    clip = tmp_path / "clip.mp4.npy"
    np.save(clip, np.random.default_rng(4).integers(0, 256, size=(60, 256, 342, 3), dtype=np.uint8))
    argv = ["--clip", str(clip), "--backbone", "timesformer_tiny", "--backbone_ckpt", bpath,
            "--decoder_ckpt", dpath, "--attn"]
    j_visualize.main([*argv, "--out_dir", str(tmp_path / "jax")])
    res = visualize.main([*argv, "--out_dir", str(tmp_path / "torch"), "--device", "cpu"])

    assert res["boxes"].shape == (4, 13, 4) and res["cross_attn"].shape == (13, 4 * 49)
    assert ((res["boxes"] >= 0) & (res["boxes"] <= 224)).all()
    np.testing.assert_allclose(res["cross_attn"].sum(-1), 1.0, atol=1e-5)
    for name, shape in (("boxes.png", (224, 4 * 224, 3)), ("cross_attn.png", (13 * 7 * 8, 4 * 7 * 8))):
        got = np.asarray(Image.open(tmp_path / "torch" / name)).astype(int)
        want = np.asarray(Image.open(tmp_path / "jax" / name)).astype(int)
        assert got.shape == want.shape == shape, name
        assert np.abs(got - want).max() <= 1, name
