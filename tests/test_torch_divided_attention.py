"""Divided attention of the PyTorch port against the JAX package.

The port's plain version plus ``merge_cls_partials`` is held, in f32,
against the JAX Pallas kernel run in interpret mode plus its merge, and
against the JAX eager oracle ``_var_attention``. The CUDA kernel against
the plain version runs only where there is a card (marker ``cuda``); the
machine with the card has no JAX, so JAX comes in through a fixture and
this file runs there with
``python -m pytest --noconftest -m cuda tests/test_torch_divided_attention.py``.
"""

import types

import numpy as np
import pytest
import torch

from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

HEADS, DH, N, B = 2, 64, 64, 2
D = HEADS * DH
ATOL = 1e-5


def _qkv_inputs(t, seed=0):
    """Tokens x (B, 1+T*N, D) and a qkv projection; returns x, w, b and
    the packed rows qkv = x @ w + b (B, 1+T*N, 3D), row 0 the CLS token."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 1 + t * N, D)).astype(np.float32)
    w = (rng.normal(size=(D, 3 * D)) * D**-0.5).astype(np.float32)
    b = (rng.normal(size=(3 * D,)) * 0.1).astype(np.float32)
    return x, w, b, (x @ w + b).astype(np.float32)


def _split(qkv, t):
    qkv_p = qkv[:, 1:].reshape(B, t, N, 3 * D)
    cls_q, cls_k, cls_v = (np.ascontiguousarray(z) for z in np.split(qkv[:, 0], 3, axis=-1))
    return qkv_p, cls_q, cls_k, cls_v


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    from helping_hand_for_egocentric_videos_tpu.models.spacetime_vit import _var_attention
    from helping_hand_for_egocentric_videos_tpu.ops import divided_attention

    return types.SimpleNamespace(jnp=jnp, da=divided_attention, var_attention=_var_attention)


def _port(qkv_p, cls_q, cls_k, cls_v, mode):
    tq, tk, tv = (torch.from_numpy(z) for z in (cls_q, cls_k, cls_v))
    out, (m, s, co) = da.divided_patch_attention_ref(
        torch.from_numpy(qkv_p), tk, tv, tq, mode=mode, heads=HEADS
    )
    cls = da.merge_cls_partials(m, s, co, tq, tk, tv, HEADS)
    return out.numpy(), cls.numpy()


@pytest.mark.parametrize("t", [2, 4, 16])
@pytest.mark.parametrize("mode", ["space", "time"])
def test_ref_matches_jax_kernel_interpret(jx, mode, t):
    jnp, jax_da = jx.jnp, jx.da
    _, _, _, qkv = _qkv_inputs(t)
    qkv_p, cls_q, cls_k, cls_v = _split(qkv, t)
    out, (m, s, co) = jax_da.divided_patch_attention(
        jnp.asarray(qkv_p), jnp.asarray(cls_k), jnp.asarray(cls_v), jnp.asarray(cls_q),
        mode=mode, heads=HEADS, interpret=True,
    )
    want_cls = jax_da.merge_cls_partials(
        m, s, co, jnp.asarray(cls_q), jnp.asarray(cls_k), jnp.asarray(cls_v), HEADS
    )
    got, got_cls = _port(qkv_p, cls_q, cls_k, cls_v, mode)
    np.testing.assert_allclose(got, np.asarray(out), atol=ATOL)
    np.testing.assert_allclose(got_cls, np.asarray(want_cls), atol=ATOL)


@pytest.mark.parametrize("t", [2, 4, 16])
@pytest.mark.parametrize("mode", ["space", "time"])
def test_ref_matches_jax_var_attention(jx, mode, t):
    """With an identity output projection, ``_var_attention`` returns the
    raw attention output of the CLS row and every patch row."""
    jnp = jx.jnp
    x, w, b, qkv = _qkv_inputs(t, seed=1)
    p = {
        "qkv": {"w": jnp.asarray(w), "b": jnp.asarray(b)},
        "proj": {"w": jnp.eye(D, dtype=jnp.float32), "b": jnp.zeros((D,), jnp.float32)},
    }
    want = np.asarray(jx.var_attention(p, jnp.asarray(x), t, N, HEADS, mode))
    got, got_cls = _port(*_split(qkv, t), mode)
    np.testing.assert_allclose(got.reshape(B, t * N, D), want[:, 1:], atol=ATOL)
    np.testing.assert_allclose(got_cls, want[:, 0], atol=ATOL)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    _, _, _, qkv = _qkv_inputs(2)
    qkv_p, cls_q, cls_k, cls_v = (torch.from_numpy(z) for z in _split(qkv, 2))
    before = (da.divided_patch_attention.launches_space, da.divided_patch_attention.launches_time)
    for mode in ("space", "time"):
        got, got_p = da.divided_patch_attention(qkv_p, cls_k, cls_v, cls_q, mode=mode, heads=HEADS)
        want, want_p = da.divided_patch_attention_ref(qkv_p, cls_k, cls_v, cls_q, mode=mode, heads=HEADS)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        for a, b in zip(got_p, want_p):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    after = (da.divided_patch_attention.launches_space, da.divided_patch_attention.launches_time)
    assert after == before


def test_wrapper_rejects_unknown_mode_and_device():
    z = torch.zeros(1, 2, 4, 3 * D)
    c = torch.zeros(1, D)
    with pytest.raises(ValueError, match="mode"):
        da.divided_patch_attention(z, c, c, c, mode="both", heads=HEADS)
    zm, cm = z.to("meta"), c.to("meta")
    with pytest.raises(ValueError, match="no divided-attention kernel"):
        da.divided_patch_attention(zm, cm, cm, cm, mode="space", heads=HEADS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc "
                    "(python -m pytest --noconftest -m cuda tests/test_torch_divided_attention.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape",  # (B, T, N, H, dh): small, ragged with dh 32, two time tiles, serving shape
    [(2, 4, 64, 2, 64), (1, 3, 49, 4, 32), (1, 128, 8, 2, 64), (2, 16, 256, 16, 64)],
)
@pytest.mark.parametrize("mode", ["space", "time"])
def test_cuda_kernel_matches_plain(cuda_device, mode, shape, dtype):
    b, t, n, heads, dh = shape
    d = heads * dh
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn(b, t, n, 3 * d, generator=g, device=cuda_device).to(dt)
    ck, cv, cq = (torch.randn(b, d, generator=g, device=cuda_device).to(dt) for _ in range(3))
    out, parts = da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=heads)
    want, want_parts = da.divided_patch_attention_ref(qkv, ck, cv, cq, mode=mode, heads=heads)
    cls = da.merge_cls_partials(*parts, cq, ck, cv, heads)
    want_cls = da.merge_cls_partials(*want_parts, cq, ck, cv, heads)
    torch.cuda.synchronize()
    # f32: only the order of the sums differs; bf16: the output's rounding
    atol = 1e-4 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=atol)
    torch.testing.assert_close(cls, want_cls, rtol=0, atol=1e-4)
