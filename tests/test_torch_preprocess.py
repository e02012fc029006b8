"""The port's eval preprocessing against the JAX package, in f32."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from helping_hand_for_egocentric_videos_tpu.ops import preprocess as jpp
from helping_hand_for_egocentric_videos_torch.ops import preprocess as tpp

ATOL = 1e-5


@pytest.mark.parametrize("hw", [(28, 28), (40, 72), (96, 48), (20, 24)])
def test_resize_normalize_matches_jax(rng, hw):
    """Identity, downscale (wide and tall) and upscale: bilinear without
    antialias on both sides."""
    clip = (rng.random((2, 3, *hw, 3)) * 255).astype(np.uint8)
    want = np.asarray(jpp.resize_normalize(jnp.asarray(clip), 28))
    got = tpp.resize_normalize(torch.from_numpy(clip), 28).numpy()
    assert got.shape == (2, 3, 28, 28, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("hw,short,res", [((60, 83), 32, 28), ((83, 60), 32, 32), ((45, 70), 40, 24)])
def test_shortside_centercrop_normalize_matches_jax(rng, hw, short, res):
    clip = (rng.random((1, 2, *hw, 3)) * 255).astype(np.uint8)
    want = np.asarray(jpp.shortside_centercrop_normalize(jnp.asarray(clip), short=short, res=res))
    got = tpp.shortside_centercrop_normalize(torch.from_numpy(clip), short=short, res=res).numpy()
    assert got.shape == (1, 2, res, res, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_shortside_dims_truncate_like_the_reference():
    for h, w, s in [(256, 455, 224), (455, 256, 224), (480, 853, 256), (97, 131, 32), (64, 64, 64)]:
        assert tpp.shortside_dims(h, w, s) == jpp.shortside_dims(h, w, s)
    # 455 * 224 / 256 = 398.125 and 853 * 256 / 480 = 454.93: truncated
    assert tpp.shortside_dims(256, 455, 224) == (224, 398)
    assert tpp.shortside_dims(480, 853, 256) == (256, 454)
