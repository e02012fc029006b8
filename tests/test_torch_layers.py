"""NN primitives of the PyTorch port against the JAX package, in f32."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from helping_hand_for_egocentric_videos_tpu.models import layers as jl
from helping_hand_for_egocentric_videos_torch.models import layers as tl
from helping_hand_for_egocentric_videos_torch.models.bridge import load_jax_params

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_linear_matches_jax(rng):
    p = _np(jl.linear_init(jax.random.PRNGKey(0), 24, 40))
    x = rng.normal(size=(3, 5, 24)).astype(np.float32)
    lin = load_jax_params(tl.linear_init(24, 40), p)
    got = tl.linear(lin, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jl.linear(p, jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_layer_norm_matches_jax(rng, eps):
    p = {
        "g": rng.normal(size=(32,)).astype(np.float32),
        "b": rng.normal(size=(32,)).astype(np.float32),
    }
    x = (rng.normal(size=(4, 7, 32)) * 3 + 1).astype(np.float32)
    ln = load_jax_params(tl.layer_norm_init(32), p)
    got = tl.layer_norm(ln, torch.from_numpy(x), eps).numpy()
    np.testing.assert_allclose(got, np.asarray(jl.layer_norm(p, jnp.asarray(x), eps)), atol=ATOL)


def test_layer_norm_keeps_bf16_and_computes_in_f32(rng):
    ln = tl.layer_norm_init(16)
    x = torch.from_numpy((rng.normal(size=(2, 16)) * 100).astype(np.float32))
    got = tl.layer_norm(ln, x.bfloat16(), 1e-6)
    assert got.dtype == torch.bfloat16
    want = tl.layer_norm(ln, x.bfloat16().float(), 1e-6)
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


def test_quick_gelu_matches_jax(rng):
    x = (rng.normal(size=(100,)) * 4).astype(np.float32)
    got = tl.quick_gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jl.quick_gelu(jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention_matches_jax(rng, masked):
    dim, heads, nq, nk = 32, 4, 5, 9
    p = _np(jl.mha_init(jax.random.PRNGKey(3), dim))
    q_in, k_in, v_in = (rng.normal(size=(2, n, dim)).astype(np.float32) for n in (nq, nk, nk))
    mask = None
    if masked:  # additive mask, -1e9 on disallowed pairs, as the text tower uses
        mask = np.where(rng.random((nq, nk)) < 0.3, -1e9, 0.0).astype(np.float32)
        mask[:, 0] = 0.0
    want = jl.multi_head_attention(
        p, jnp.asarray(q_in), jnp.asarray(k_in), jnp.asarray(v_in), heads,
        mask=None if mask is None else jnp.asarray(mask),
    )
    mha = load_jax_params(tl.MultiheadAttention(dim), p)
    got = tl.multi_head_attention(
        mha, torch.from_numpy(q_in), torch.from_numpy(k_in), torch.from_numpy(v_in), heads,
        mask=None if mask is None else torch.from_numpy(mask),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_linear_init_is_seeded_and_bounded():
    a = tl.linear_init(64, 8, generator=torch.Generator().manual_seed(1))
    b = tl.linear_init(64, 8, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a.weight, b.weight, rtol=0, atol=0)
    assert a.weight.shape == (8, 64) and a.weight.abs().max() <= 64**-0.5
    c = tl.linear_init(64, 8, std=0.02, bias=False, generator=torch.Generator().manual_seed(1))
    assert c.bias is None and 0.01 < c.weight.std() < 0.03


def test_dropout_without_generator_is_the_identity(rng):
    x = torch.from_numpy(rng.normal(size=(4, 9)).astype(np.float32))
    assert tl.dropout(None, x, 0.1) is x
    assert tl.dropout(torch.Generator().manual_seed(0), x, 0.1, deterministic=True) is x
    assert tl.dropout(torch.Generator().manual_seed(0), x, 0.0) is x


def test_dropout_keeps_the_mean():
    """Over 10^6 draws at rate 0.1: the kept share within 0.002 of 0.9 (30
    standard deviations of a binomial share), the kept values scaled by
    exactly 1 / 0.9, the mean within 0.005 of 1; the same seed draws the
    same mask."""
    x = torch.ones(1000, 1000)
    y = tl.dropout(torch.Generator().manual_seed(3), x, 0.1)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 2e-3
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9), rtol=0, atol=0)
    assert abs(y.mean().item() - 1.0) < 5e-3
    torch.testing.assert_close(tl.dropout(torch.Generator().manual_seed(3), x, 0.1), y, rtol=0, atol=0)


def test_attention_dropout_mean_and_pre_dropout_weights(rng):
    """Attention-weight dropout: no generator gives eval mode exactly; with
    one, ``return_probs`` gives the weights before dropout (the JAX
    package's ``return_probs``), and the output averaged over 4000 draws
    is within 0.02 of the eval output (unbiased, inverted scaling)."""
    dim, heads, nq, nk, draws = 16, 2, 3, 6, 4000
    p = _np(jl.mha_init(jax.random.PRNGKey(5), dim))
    mha = load_jax_params(tl.MultiheadAttention(dim), p)
    q_in, k_in = (rng.normal(size=(1, n, dim)).astype(np.float32) for n in (nq, nk))
    q, k = torch.from_numpy(q_in), torch.from_numpy(k_in)
    want_out, want_probs = jl.multi_head_attention(p, jnp.asarray(q_in), jnp.asarray(k_in), jnp.asarray(k_in), heads,
                                                   return_probs=True)
    ev_out, ev_probs = tl.multi_head_attention(mha, q, k, k, heads, return_probs=True)
    np.testing.assert_allclose(ev_out.numpy(), np.asarray(want_out), atol=ATOL)
    np.testing.assert_allclose(ev_probs.numpy(), np.asarray(want_probs), atol=ATOL)
    off = tl.multi_head_attention(mha, q, k, k, heads, dropout_rate=0.5)
    torch.testing.assert_close(off, ev_out, rtol=0, atol=0)

    qs, ks = q.expand(draws, nq, dim), k.expand(draws, nk, dim)
    out, probs = tl.multi_head_attention(mha, qs, ks, ks, heads, return_probs=True,
                                         generator=torch.Generator().manual_seed(1), dropout_rate=0.5)
    torch.testing.assert_close(probs, ev_probs.expand_as(probs), rtol=0, atol=1e-6)
    assert (out - ev_out).abs().max() > 0.1  # single draws do differ
    assert (out.mean(0) - ev_out[0]).abs().max() < 0.02
