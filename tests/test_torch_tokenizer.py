"""The port's own tokenizer copy gives exactly the JAX package's tokens."""

import numpy as np

from helping_hand_for_egocentric_videos_tpu.data.tokenizer import ClipTokenizer as JaxTokenizer
from helping_hand_for_egocentric_videos_torch.data.tokenizer import ClipTokenizer

TEXTS = [
    "#C C picks a knife from the counter",
    "wash hands",
    "Cut the onion into small pieces, then put them in the pan!",
    "open fridge &amp; take out milk",
    "x" * 300,  # truncated at the context length
    "",
    "café naïve 42 tomatoes",
]


def test_tokens_equal_jax_tokenizer():
    got = ClipTokenizer()(TEXTS)
    want = JaxTokenizer()(TEXTS)
    assert got.dtype == np.int32 and got.shape == (len(TEXTS), 77)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ClipTokenizer()("wash hands"), want[1:2])


def test_port_asset_is_a_copy():
    from pathlib import Path

    from helping_hand_for_egocentric_videos_tpu.data import tokenizer as jt
    from helping_hand_for_egocentric_videos_torch.data import tokenizer as tt

    assert Path(tt.DEFAULT_BPE_PATH).read_bytes() == Path(jt.DEFAULT_BPE_PATH).read_bytes()
    assert "helping_hand_for_egocentric_videos_torch" in tt.DEFAULT_BPE_PATH
