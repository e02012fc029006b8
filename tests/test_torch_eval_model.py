"""The slice as a whole: the port's ``EvalModel`` against the JAX one.

Both at ``timesformer_tiny_config`` with the same weights (carried across
by ``from_jax_params``), in f32; the JAX tower runs its Pallas kernel in
interpret mode, the port its kernel wrapper (the plain version on the
CPU). Text embeddings, video embeddings and boxes agree to 1e-4, for the
'resize' and 'shortside' preprocessing.

With ``int8=True`` each side quantizes its own f32 weights (the codes are
equal, ``test_torch_quant.py``) and the video embeddings agree to
1e-2 x max|embedding| (a value on a rounding boundary may take the
neighbouring code, ``test_torch_spacetime_vit.py``), pure int8 and with a
fallback threshold that sends one block to its float matmuls.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from helping_hand_for_egocentric_videos_tpu.data.tokenizer import ClipTokenizer as JaxTokenizer
from helping_hand_for_egocentric_videos_tpu.models import lavila as jlv
from helping_hand_for_egocentric_videos_tpu.models import obj_decoder as jod
from helping_hand_for_egocentric_videos_tpu.train.evaluate import EvalModel as JaxEvalModel
from helping_hand_for_egocentric_videos_torch.data import ClipTokenizer
from helping_hand_for_egocentric_videos_torch.models import DecoderConfig, from_jax_params
from helping_hand_for_egocentric_videos_torch.models.lavila import timesformer_tiny_config
from helping_hand_for_egocentric_videos_torch.train import EvalModel

ATOL = 1e-4
T = 4
DEC = dict(
    d_model=64, nhead=4, num_layers=2, dim_feedforward=128, num_queries=13, num_classes=10,
    feature_dim=128, text_width=64, embed_dim=32, num_frames=T, patches_per_frame=49,
    pred_traj=False,
)
TEXTS = ["#C C cuts the onion", "wash hands", "open the fridge door"]


def _jax_trees():
    jcfg = jlv.timesformer_tiny_config(num_frames=T)
    backbone = jax.tree.map(np.asarray, jlv.init_lavila_params(jax.random.PRNGKey(0), jcfg))
    decoder = jax.tree.map(np.asarray, jod.init_decoder_params(jax.random.PRNGKey(1), jod.DecoderConfig(**DEC)))
    rng = np.random.default_rng(3)
    ta = backbone["visual"]["blocks"]["timeattn"]  # zero init would feed the time attention zeros
    for name in ("qkv", "proj"):
        ta[name]["w"] = (rng.normal(size=ta[name]["w"].shape) * 0.05).astype(np.float32)
    return jcfg, backbone, decoder


@pytest.fixture(scope="module")
def models():
    jcfg, backbone, decoder = _jax_trees()
    out = {}
    for prep in ("resize", "shortside"):
        jax_model = JaxEvalModel(
            backbone_params=backbone,
            lavila_cfg=replace(jcfg, visual=replace(jcfg.visual, attention_backend="pallas_interpret")),
            decoder_params=decoder, dec_cfg=jod.DecoderConfig(**DEC),
            tokenizer=JaxTokenizer(), preprocess=prep, dtype=jnp.float32,
        )
        cfg, dcfg = timesformer_tiny_config(num_frames=T), DecoderConfig(**DEC)
        bb, dec = from_jax_params(backbone, decoder, cfg, dcfg)
        port = EvalModel(bb, cfg, dec, dcfg, ClipTokenizer(), preprocess=prep,
                         dtype=torch.float32, device="cpu")
        out[prep] = (jax_model, port)
    return out


def test_text_embeddings_match_jax(models):
    jax_model, port = models["resize"]
    got = port.embed_text(TEXTS)
    assert got.shape == (3, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_model.embed_text(TEXTS), atol=ATOL)


@pytest.mark.parametrize("prep", ["resize", "shortside"])
def test_video_embeddings_and_boxes_match_jax(models, prep):
    jax_model, port = models[prep]
    video = (np.random.default_rng(4).random((2, T, 240, 320, 3)) * 255).astype(np.uint8)
    emb, boxes = port.embed_video(video)
    want_emb, want_boxes = jax_model.embed_video(video)
    assert emb.shape == (2, 32) and boxes.shape == (2, 13, 4)
    np.testing.assert_allclose(emb, want_emb, atol=ATOL)
    np.testing.assert_allclose(boxes, want_boxes, atol=ATOL)


INT8_RTOL = 1e-2


@pytest.mark.parametrize("fallback", [None, 4.0], ids=["pure", "fallback"])
def test_int8_video_embeddings_match_jax(fallback):
    jcfg, backbone, decoder = _jax_trees()
    g = backbone["visual"]["blocks"]["norm2"]["g"] = np.array(backbone["visual"]["blocks"]["norm2"]["g"])
    g[0, :3] = 16.0  # block 0 falls back at 4.0
    jax_model = JaxEvalModel(
        backbone_params=backbone,
        lavila_cfg=replace(jcfg, visual=replace(jcfg.visual, attention_backend="pallas_interpret")),
        decoder_params=decoder, dec_cfg=jod.DecoderConfig(**DEC), tokenizer=JaxTokenizer(),
        dtype=jnp.float32, int8=True, int8_fallback=fallback,
    )
    cfg, dcfg = timesformer_tiny_config(num_frames=T), DecoderConfig(**DEC)
    bb, dec = from_jax_params(backbone, decoder, cfg, dcfg)
    port = EvalModel(bb, cfg, dec, dcfg, ClipTokenizer(), dtype=torch.float32, device="cpu",
                     int8=True, int8_fallback=fallback)
    assert port.int8 and port.visual.blocks[0].mlp_fc1.w_q.dtype == torch.int8
    assert (port.visual.blocks[0].mlp_fc1.q_on is None) == (fallback is None)
    video = (np.random.default_rng(5).random((2, T, 224, 224, 3)) * 255).astype(np.uint8)
    emb, boxes = port.embed_video(video)
    want_emb, want_boxes = jax_model.embed_video(video)
    assert emb.shape == (2, 32) and np.isfinite(emb).all()
    np.testing.assert_allclose(emb, want_emb, atol=INT8_RTOL * np.abs(want_emb).max())
    np.testing.assert_allclose(boxes, want_boxes, atol=INT8_RTOL * np.abs(want_boxes).max())


def test_eval_model_rejects_unknown_preprocess(models):
    _, port = models["resize"]
    with pytest.raises(ValueError, match="preprocess"):
        EvalModel(port.backbone, port.lavila_cfg, port.decoder, port.dec_cfg, ClipTokenizer(),
                  preprocess="crops3", device="cpu")
