"""Int8 quantization of the PyTorch port against the JAX ``models/quant.py``.

- ``quantize_lavila_params``: the codes, scales, biases, fallback flags and
  kept float weights equal JAX's bit for bit (``assert_array_equal``),
  without a threshold and with one that sends one block to the fallback.
- ``_gamma_spread``: equal to JAX's at an even width, where ``jnp.median``
  averages the two middle values (``torch.median`` would take the lower).
- ``int8_linear``, ``int8_linear_prequant`` and ``mixed_linear`` equal
  JAX's to 1e-5 x max|y| (the int32 products are exact; only the f32
  dequantization may round differently), in f32 and bf16, including a
  row count below the 17 rows ``torch._int_mm`` needs on the card.
- The bridge carries a JAX-quantized tree into the port with the same
  codes, and ``cast_floats`` keeps the scales in f32.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from helping_hand_for_egocentric_videos_tpu.models import lavila as jlv
from helping_hand_for_egocentric_videos_tpu.models import quant as jq
from helping_hand_for_egocentric_videos_torch.models import quant as tq
from helping_hand_for_egocentric_videos_torch.models.bridge import load_jax_params
from helping_hand_for_egocentric_videos_torch.models.lavila import Lavila, timesformer_tiny_config

THRESHOLD = 4.0
_FAMILIES = (("attn", "qkv"), ("attn", "proj"), ("timeattn", "qkv"), ("timeattn", "proj"),
             (None, "mlp_fc1"), (None, "mlp_fc2"))


def _tree(outlier_block=None):
    """JAX tiny LaviLa params as numpy; LN gammas with a spread, and 16x
    outlier channels in one block's norm2 when ``outlier_block`` is set."""
    tree = jax.tree.map(np.asarray, jlv.init_lavila_params(jax.random.PRNGKey(0),
                                                            jlv.timesformer_tiny_config()))
    rng = np.random.default_rng(0)
    blocks = tree["visual"]["blocks"]
    for name in ("norm1", "norm2", "norm3"):
        g = blocks[name]["g"]
        blocks[name]["g"] = (1.0 + 0.1 * rng.normal(size=g.shape)).astype(np.float32)
    if outlier_block is not None:
        blocks["norm2"]["g"][outlier_block, :3] = 16.0
    ta = blocks["timeattn"]
    for name in ("qkv", "proj"):
        ta[name]["w"] = (rng.normal(size=ta[name]["w"].shape) * 0.02).astype(np.float32)
    return tree


def _jax_linear(tree, i, key, sub):
    blk = tree["visual"]["blocks"]
    lin = blk[sub] if key is None else blk[key][sub]
    return {k: np.asarray(v)[i] for k, v in lin.items()}


def _port_linear(lavila, i, key, sub):
    blk = lavila.visual.blocks[i]
    return getattr(blk, sub) if key is None else getattr(getattr(blk, key), sub)


@pytest.mark.parametrize("threshold", [None, THRESHOLD], ids=["pure", "fallback"])
def test_quantize_lavila_params_matches_jax_bit_for_bit(threshold):
    tree = _tree(outlier_block=0)
    want = jax.tree.map(np.asarray, jq.quantize_lavila_params(tree, act_outlier_threshold=threshold))
    f32 = load_jax_params(Lavila(timesformer_tiny_config()), tree)
    got = tq.quantize_lavila_params(f32, act_outlier_threshold=threshold)
    assert isinstance(f32.visual.blocks[0].attn.qkv, torch.nn.Linear)  # a copy; the input stays
    depth = len(got.visual.blocks)
    for key, sub in _FAMILIES:
        for i in range(depth):
            w, q = _jax_linear(want, i, key, sub), _port_linear(got, i, key, sub)
            assert q.w_q.dtype == torch.int8 and q.s_w.dtype == torch.float32
            np.testing.assert_array_equal(q.w_q.numpy(), w["w_q"].T)
            np.testing.assert_array_equal(q.s_w.numpy(), w["s_w"])
            np.testing.assert_array_equal(q.bias.numpy(), w["b"])
            assert ("q_on" in w) == (q.q_on is not None)
            if threshold is not None:
                assert bool(q.q_on) == bool(w["q_on"]) == (i != 0)
                np.testing.assert_array_equal(q.weight.numpy(), w["w"].T)
    # the text tower and the patch embedding stay float
    assert isinstance(got.visual.patch_embed, torch.nn.Linear)
    assert not any(isinstance(m, tq.QuantLinear) for m in got.text.modules())


@pytest.mark.parametrize("width", [128, 127])
def test_gamma_spread_matches_jax_median(width):
    g = np.random.default_rng(1).normal(size=(3, width)).astype(np.float32)
    want = np.asarray(jq._gamma_spread(jnp.asarray(g)))
    got = tq._gamma_spread(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got, want)
    if width % 2 == 0:  # the lower middle value would give another score
        low = np.abs(g).max(-1) / torch.from_numpy(np.abs(g)).median(-1).values.numpy()
        assert not np.array_equal(low, want)


def _linear_pair(d_in=64, d_out=48, seed=2):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(d_in, d_out)) * d_in**-0.5).astype(np.float32)
    b = (rng.normal(size=(d_out,)) * 0.1).astype(np.float32)
    jp = jq.quantize_linear_params({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    lin = torch.nn.Linear(d_in, d_out)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
    tp = tq.quantize_linear_params(lin)
    np.testing.assert_array_equal(tp.w_q.numpy(), np.asarray(jp["w_q"]).T)
    np.testing.assert_array_equal(tp.s_w.numpy(), np.asarray(jp["s_w"]))
    return w, jp, tp


def _x(shape, dtype, seed=3):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x).astype(getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 40, 64)])
def test_int8_linear_matches_jax(shape, dtype):
    _, jp, tp = _linear_pair()
    jx, tx = _x(shape, dtype)
    got = tq.int8_linear(tp, tx)
    assert got.dtype == tx.dtype and got.shape == (*shape[:-1], 48)
    _close(got, jq.int8_linear(jp, jx))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_linear_prequant_matches_jax(out_dtype):
    _, jp, tp = _linear_pair(seed=4)
    rng = np.random.default_rng(5)
    x_q = rng.integers(-127, 128, size=(2, 9, 64)).astype(np.int8)
    s_x = (rng.random(size=(2, 9, 1)) * 0.1).astype(np.float32)
    want = jq.int8_linear_prequant(jp, jnp.asarray(x_q), jnp.asarray(s_x),
                                   out_dtype=getattr(jnp, out_dtype))
    got = tq.int8_linear_prequant(tp, torch.from_numpy(x_q), torch.from_numpy(s_x),
                                  out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    _close(got, want)


@pytest.mark.parametrize("q_on", [True, False])
def test_mixed_linear_matches_jax(q_on):
    w, jp, tp = _linear_pair(seed=6)
    jp = {**jp, "q_on": jnp.asarray(q_on), "w": jnp.asarray(w)}
    tp = tq.QuantLinear(tp.w_q, tp.s_w, tp.bias, weight=torch.from_numpy(w.T.copy()),
                        q_on=torch.tensor(q_on))
    jx, tx = _x((2, 20, 64), "float32", seed=7)
    _close(tq.mixed_linear(tp, tx), jq.mixed_linear(jp, jx))


def test_int8_matmul_pads_short_inputs_exactly():
    rng = np.random.default_rng(8)
    w_q = torch.from_numpy(rng.integers(-127, 128, size=(24, 64)).astype(np.int8))
    for rows in (1, 3, 16, 40):
        x_q = torch.from_numpy(rng.integers(-127, 128, size=(rows, 64)).astype(np.int8))
        got = tq._int8_matmul(x_q, w_q)
        assert got.dtype == torch.int32 and got.shape == (rows, 24)
        torch.testing.assert_close(got, x_q.int() @ w_q.int().T, rtol=0, atol=0)


def test_bridge_carries_a_quantized_jax_tree_with_the_same_codes():
    tree = _tree(outlier_block=1)
    qtree = jax.tree.map(np.asarray, jq.quantize_lavila_params(tree, act_outlier_threshold=THRESHOLD))
    bridged = load_jax_params(Lavila(timesformer_tiny_config()), qtree)
    ported = tq.quantize_lavila_params(load_jax_params(Lavila(timesformer_tiny_config()), tree),
                                       act_outlier_threshold=THRESHOLD)
    for key, sub in _FAMILIES:
        for i in range(len(bridged.visual.blocks)):
            a, b = _port_linear(bridged, i, key, sub), _port_linear(ported, i, key, sub)
            assert isinstance(a, tq.QuantLinear) and a.w_q.dtype == torch.int8
            for name in ("w_q", "s_w", "bias", "weight", "q_on"):
                torch.testing.assert_close(getattr(a, name), getattr(b, name), rtol=0, atol=0)
            assert bool(a.q_on) == (i != 1)


def test_cast_floats_keeps_the_scales_f32():
    lav = tq.quantize_lavila_params(load_jax_params(Lavila(timesformer_tiny_config()), _tree()))
    vis = tq.cast_floats(lav.visual, torch.bfloat16)
    q, q32 = vis.blocks[0].mlp_fc1, lav.visual.blocks[0].mlp_fc1
    assert q.s_w.dtype == torch.float32 and q.w_q.dtype == torch.int8
    assert q.bias.dtype == torch.bfloat16 and vis.blocks[0].norm1.weight.dtype == torch.bfloat16
    torch.testing.assert_close(q.s_w, q32.s_w, rtol=0, atol=0)
    assert q32.bias.dtype == torch.float32  # the source is untouched
