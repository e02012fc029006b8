"""The port's TimeSformer tower against the JAX ``spacetime_forward``.

Sizes as in ``tests/test_models.py::test_backbone_pallas_interpret_matches_xla``
(img 112, patch 14, width 128, heads 2, depth 2), at T=4 and T=16. The
JAX side runs through the Pallas kernel in interpret mode and through its
XLA path; the port through its kernel wrapper (the plain version on the
CPU) and through its eager oracle. Time attention is given random weights:
its zero init would feed the attention zeros. All in f32.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from helping_hand_for_egocentric_videos_tpu.models.spacetime_vit import (
    SpaceTimeConfig as JaxConfig,
    init_spacetime_params,
    spacetime_forward as jax_forward,
)
from helping_hand_for_egocentric_videos_torch.models.bridge import load_jax_params
from helping_hand_for_egocentric_videos_torch.models.spacetime_vit import (
    SpaceTimeConfig,
    SpaceTimeViT,
    spacetime_forward,
)

ATOL = 2e-5
_JAX_OUT = {}  # one JAX forward per (t, backend), shared by the port's backends


def _params(t):
    cfg = JaxConfig(img_size=112, patch_size=14, width=128, depth=2, heads=2, num_frames=t)
    params = jax.tree.map(np.asarray, init_spacetime_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(5)
    ta = params["blocks"]["timeattn"]
    for name in ("qkv", "proj"):
        for k in ("w", "b"):
            ta[name][k] = (rng.normal(size=ta[name][k].shape) * 0.05).astype(np.float32)
    # non-trivial CLS and temporal embeddings exercise the split CLS path
    params["cls_token"] = rng.normal(size=params["cls_token"].shape).astype(np.float32)
    params["temporal_embed"] = (rng.normal(size=params["temporal_embed"].shape) * 0.1).astype(np.float32)
    video = rng.normal(size=(2, t, 112, 112, 3)).astype(np.float32)
    return cfg, params, video


def _jax(t, backend):
    key = (t, backend)
    if key not in _JAX_OUT:
        cfg, params, video = _params(t)
        cls, tok = jax_forward(
            params, replace(cfg, attention_backend=backend), jnp.asarray(video),
            use_remat=False, dtype=jnp.float32,
        )
        _JAX_OUT[key] = (np.asarray(cls), np.asarray(tok))
    return _JAX_OUT[key]


@pytest.mark.parametrize("port_backend", ["kernel", "reference"])
@pytest.mark.parametrize("jax_backend", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("t", [4, 16])
def test_spacetime_forward_matches_jax(t, jax_backend, port_backend):
    jcfg, params, video = _params(t)
    cfg = SpaceTimeConfig(
        img_size=112, patch_size=14, width=128, depth=2, heads=2, num_frames=t,
        attention_backend=port_backend,
    )
    vit = load_jax_params(SpaceTimeViT(cfg), params)
    with torch.inference_mode():
        cls, tok = spacetime_forward(vit, cfg, torch.from_numpy(video), dtype=torch.float32)
    want_cls, want_tok = _jax(t, jax_backend)
    assert tok.shape == (2, 1 + t * cfg.patches_per_frame, 128) and tok.dtype == torch.float32
    np.testing.assert_allclose(tok.numpy(), want_tok, atol=ATOL)
    np.testing.assert_allclose(cls.numpy(), want_cls, atol=ATOL)


def test_bf16_forward_keeps_bf16_stream_and_returns_f32():
    cfg = SpaceTimeConfig(img_size=56, patch_size=14, width=64, depth=1, heads=1, num_frames=2)
    vit = SpaceTimeViT(cfg, generator=torch.Generator().manual_seed(0))
    video = torch.randn(1, 2, 56, 56, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        cls, tok = spacetime_forward(vit, cfg, video, dtype=torch.bfloat16)
        cls32, tok32 = spacetime_forward(vit, cfg, video, dtype=torch.float32)
    assert cls.dtype == tok.dtype == torch.float32
    cos = torch.nn.functional.cosine_similarity(tok.flatten(1), tok32.flatten(1))
    assert cos.min() > 0.99


def test_unknown_attention_backend_raises():
    cfg = SpaceTimeConfig(img_size=28, patch_size=14, width=64, depth=1, heads=1, num_frames=1,
                          attention_backend="xla")
    vit = SpaceTimeViT(cfg)
    with pytest.raises(ValueError, match="attention_backend"):
        spacetime_forward(vit, cfg, torch.zeros(1, 1, 28, 28, 3), dtype=torch.float32)
