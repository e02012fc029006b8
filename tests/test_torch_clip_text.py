"""The port's CLIP text tower and LaviLa wrapper against the JAX package, in f32."""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from helping_hand_for_egocentric_videos_tpu.models import clip_text as jct
from helping_hand_for_egocentric_videos_tpu.models import lavila as jlv
from helping_hand_for_egocentric_videos_torch.models import clip_text as tct
from helping_hand_for_egocentric_videos_torch.models import lavila as tlv
from helping_hand_for_egocentric_videos_torch.models.bridge import load_jax_params

ATOL = 1e-5


def _tokens(rng, b, n, vocab):
    """Token rows shaped like the tokenizer's: SOT, words, a unique EOT
    (the largest id) at a varying position, zero padding."""
    tok = np.zeros((b, n), np.int32)
    for i in range(b):
        k = 3 + i
        tok[i, :k] = rng.integers(1, vocab - 2, size=k)
        tok[i, k] = vocab - 1
    return tok


def test_encode_text_matches_jax(rng):
    cfg = jct.TextConfig(vocab_size=300, context_length=16, width=64, heads=4, layers=2, embed_dim=24)
    params = jax.tree.map(np.asarray, jct.init_text_params(jax.random.PRNGKey(2), cfg))
    tok = _tokens(rng, 3, cfg.context_length, cfg.vocab_size)
    want_emb, want_map = jct.encode_text(params, cfg, jnp.asarray(tok))
    tcfg = tct.TextConfig(vocab_size=300, context_length=16, width=64, heads=4, layers=2, embed_dim=24)
    tower = load_jax_params(tct.TextTransformer(tcfg), params)
    with torch.inference_mode():
        emb, fmap = tct.encode_text(tower, tcfg, torch.from_numpy(tok).long())
    np.testing.assert_allclose(fmap.numpy(), np.asarray(want_map), atol=ATOL)
    np.testing.assert_allclose(emb.numpy(), np.asarray(want_emb), atol=ATOL)


def test_lavila_forward_matches_jax(rng):
    """The whole dual encoder at the tiny config: both towers, the image
    projection, the L2 normalisation and the logit scale."""
    jcfg = jlv.timesformer_tiny_config(num_frames=2)
    params = jax.tree.map(np.asarray, jlv.init_lavila_params(jax.random.PRNGKey(4), jcfg))
    video = rng.normal(size=(2, 2, 224, 224, 3)).astype(np.float32)
    tok = _tokens(rng, 2, 77, jcfg.text.vocab_size)
    want = jlv.lavila_forward(params, jcfg, jnp.asarray(video), jnp.asarray(tok), dtype=jnp.float32)
    cfg = tlv.timesformer_tiny_config(num_frames=2)
    model = load_jax_params(tlv.Lavila(cfg), params)
    with torch.inference_mode():
        got = tlv.lavila_forward(
            model, cfg, torch.from_numpy(video), torch.from_numpy(tok).long(), dtype=torch.float32
        )
    for k in ("image_embed", "text_embed", "image_feature_map", "text_feature_map", "logit_scale"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, err_msg=k)
