"""The port's object decoder and projection heads against the JAX package, in f32."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from helping_hand_for_egocentric_videos_tpu.models import obj_decoder as jod
from helping_hand_for_egocentric_videos_torch.models import obj_decoder as tod
from helping_hand_for_egocentric_videos_torch.models.bridge import load_jax_params

ATOL = 1e-5
SMALL = dict(
    d_model=32, nhead=4, num_layers=3, dim_feedforward=64, num_classes=6,
    feature_dim=48, text_width=40, embed_dim=16, num_frames=3, patches_per_frame=4,
)


@pytest.mark.parametrize(
    "num_queries,pred_traj,t",
    [
        (5, True, 3),  # trajectory conditioning: per-frame boxes
        (5, True, 2),  # T != num_frames: no conditioning
        (5, False, 3),
        (1, True, 3),  # one query decodes n_decode boxes
    ],
)
def test_decoder_forward_matches_jax(rng, num_queries, pred_traj, t):
    kw = dict(SMALL, num_queries=num_queries, pred_traj=pred_traj, n_decode=4)
    params = jax.tree.map(np.asarray, jod.init_decoder_params(jax.random.PRNGKey(7), jod.DecoderConfig(**kw)))
    feats = rng.normal(size=(2, t, 4, 48)).astype(np.float32)
    want = jod.decoder_forward(params, jod.DecoderConfig(**kw), jnp.asarray(feats))
    cfg = tod.DecoderConfig(**kw)
    dec = load_jax_params(tod.ObjDecoder(cfg), params)
    with torch.inference_mode():
        got = tod.decoder_forward(dec, cfg, torch.from_numpy(feats))
    for k in ("pred_logits", "pred_boxes", "aux_pred_logits", "aux_pred_boxes", "hs"):
        g, w = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=k)


def test_projection_heads_match_jax(rng):
    kw = dict(SMALL, num_queries=5)
    params = jax.tree.map(np.asarray, jod.init_decoder_params(jax.random.PRNGKey(8), jod.DecoderConfig(**kw)))
    dec = load_jax_params(tod.ObjDecoder(tod.DecoderConfig(**kw)), params)
    x_txt = rng.normal(size=(3, 40)).astype(np.float32)
    x_obj = rng.normal(size=(3, 32)).astype(np.float32)
    with torch.inference_mode():
        pairs = [
            (tod.txt_proj(dec, torch.from_numpy(x_txt)), jod.txt_proj(params, jnp.asarray(x_txt))),
            (tod.vid_proj(dec, torch.from_numpy(x_txt)), jod.vid_proj(params, jnp.asarray(x_txt))),
            (tod.obj_proj(dec, torch.from_numpy(x_obj)), jod.obj_proj(params, jnp.asarray(x_obj))),
        ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_port_init_matches_jax_layout():
    """The port's own init builds every parameter the JAX tree has, with
    the same shapes (after the bridge's Linear transpose)."""
    from helping_hand_for_egocentric_videos_torch.models.bridge import jax_tree_to_state_dict

    for nq in (13, 1):
        kw = dict(SMALL, num_queries=nq)
        tree = jod.init_decoder_params(jax.random.PRNGKey(0), jod.DecoderConfig(**kw))
        want = {k: tuple(v.shape) for k, v in jax_tree_to_state_dict(jax.tree.map(np.asarray, tree)).items()}
        dec = tod.ObjDecoder(tod.DecoderConfig(**kw), generator=torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in dec.state_dict().items()} == want


def test_train_mode_without_generator_is_eval_mode(rng):
    kw = dict(SMALL, num_queries=5)
    params = jax.tree.map(np.asarray, jod.init_decoder_params(jax.random.PRNGKey(9), jod.DecoderConfig(**kw)))
    cfg = tod.DecoderConfig(**kw)
    dec = load_jax_params(tod.ObjDecoder(cfg), params)
    feats = torch.from_numpy(rng.normal(size=(2, 3, 4, 48)).astype(np.float32))
    with torch.inference_mode():
        ev = tod.decoder_forward(dec, cfg, feats)
        train_no_gen = tod.decoder_forward(dec, cfg, feats, deterministic=False)
        det_with_gen = tod.decoder_forward(dec, cfg, feats, generator=torch.Generator().manual_seed(0))
    for out in (train_no_gen, det_with_gen):
        for k in ("pred_boxes", "hs", "pred_logits"):
            torch.testing.assert_close(getattr(out, k), getattr(ev, k), rtol=0, atol=0)


def test_train_mode_dropout_is_seeded_and_unbiased(rng):
    """Dropout draws from the generator: a seed reproduces the output,
    another seed differs (the mean of each draw is held in
    ``test_torch_layers.py``; the LayerNorms and ReLUs here do not keep it)."""
    kw = dict(SMALL, num_queries=5, num_layers=1)
    params = jax.tree.map(np.asarray, jod.init_decoder_params(jax.random.PRNGKey(10), jod.DecoderConfig(**kw)))
    cfg = tod.DecoderConfig(**kw)
    assert cfg.dropout == jod.DecoderConfig().dropout == 0.1
    dec = load_jax_params(tod.ObjDecoder(cfg), params)
    feats = torch.from_numpy(rng.normal(size=(2, 3, 4, 48)).astype(np.float32))

    def run(seed):
        with torch.inference_mode():
            return tod.decoder_forward(dec, cfg, feats, generator=torch.Generator().manual_seed(seed),
                                       deterministic=False).hs[-1]

    a, b, a2 = run(1), run(2), run(1)
    torch.testing.assert_close(a, a2, rtol=0, atol=0)
    assert (a - b).abs().max() > 0.1
