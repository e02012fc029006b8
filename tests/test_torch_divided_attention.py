"""Divided attention of the PyTorch port against the JAX package.

The port's plain version plus ``merge_cls_partials`` is held, in f32,
against the JAX Pallas kernel run in interpret mode plus its merge, and
against the JAX eager oracle ``_var_attention``; with ``quant_out`` (K3)
its codes and scales against the JAX kernel's ``quant_out`` with the
JAX package's tolerances for quantized outputs. The CUDA kernel against
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


def _assert_codes_close(got, want, max_changed=None):
    """Quantized outputs of two computations of the same f32 rows: scales
    within rtol 1e-5, codes within 1 (a value on a rounding boundary may
    fall either way when the sums run in another order), dequantized
    values within 1.01 x the largest scale; at most ``max_changed`` of the
    codes differ at all."""
    (q, s), (wq, ws) = got, want
    q, s, wq, ws = (np.asarray(z) for z in (q, s, wq, ws))
    assert q.dtype == np.int8 and s.dtype == np.float32 and s.shape == q.shape[:-1] + (1,)
    np.testing.assert_allclose(s, ws, rtol=1e-5)
    diff = np.abs(q.astype(np.int32) - wq.astype(np.int32))
    assert diff.max() <= 1
    if max_changed is not None:
        assert np.count_nonzero(diff) <= max_changed * diff.size
    np.testing.assert_allclose(q.astype(np.float32) * s, wq.astype(np.float32) * ws,
                               atol=1.01 * ws.max())


@pytest.mark.parametrize("t", [2, 16])
@pytest.mark.parametrize("mode", ["space", "time"])
def test_ref_quant_out_matches_jax_kernel_interpret(jx, mode, t):
    """K3: the output quantized per token over all heads (not per head),
    from the f32 output; the CLS partials are those without the flag."""
    jnp, jax_da = jx.jnp, jx.da
    _, _, _, qkv = _qkv_inputs(t, seed=2)
    qkv_p, cls_q, cls_k, cls_v = _split(qkv, t)
    (want_q, want_s), want_parts = jax_da.divided_patch_attention(
        jnp.asarray(qkv_p), jnp.asarray(cls_k), jnp.asarray(cls_v), jnp.asarray(cls_q),
        mode=mode, heads=HEADS, interpret=True, quant_out=True,
    )
    args = (torch.from_numpy(qkv_p), *(torch.from_numpy(z) for z in (cls_k, cls_v, cls_q)))
    (q, s), parts = da.divided_patch_attention_ref(*args, mode=mode, heads=HEADS, quant_out=True)
    out, parts0 = da.divided_patch_attention_ref(*args, mode=mode, heads=HEADS)
    assert q.shape == out.shape and s.shape == (*out.shape[:-1], 1)
    _assert_codes_close((q.numpy(), s.numpy()), (want_q, want_s))
    # one scale per token over all D channels: a per-head scale would differ
    per_head = np.abs(out.numpy().reshape(*out.shape[:-1], HEADS, DH)).max(-1) / 127.0
    assert not np.allclose(per_head, s.numpy(), rtol=1e-3)
    for a, b in zip(parts, parts0):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the TPU's time-mode partials are per tile of tubes: compare them merged
    want_cls = jax_da.merge_cls_partials(
        *want_parts, jnp.asarray(cls_q), jnp.asarray(cls_k), jnp.asarray(cls_v), HEADS
    )
    got_cls = da.merge_cls_partials(*parts, args[3], args[1], args[2], HEADS)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), atol=ATOL)


def test_wrapper_quant_out_on_cpu_is_the_plain_version_and_counts_nothing():
    _, _, _, qkv = _qkv_inputs(2)
    args = tuple(torch.from_numpy(z) for z in _split(qkv, 2))
    args = (args[0], args[2], args[3], args[1])  # qkv, cls_k, cls_v, cls_q
    counts = ("launches_space", "launches_time", "launches_space_quant", "launches_time_quant")
    before = [getattr(da.divided_patch_attention, c) for c in counts]
    for mode in ("space", "time"):
        (q, s), parts = da.divided_patch_attention(*args, mode=mode, heads=HEADS, quant_out=True)
        (wq, ws), wparts = da.divided_patch_attention_ref(*args, mode=mode, heads=HEADS, quant_out=True)
        for a, b in zip((q, s, *parts), (wq, ws, *wparts)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert [getattr(da.divided_patch_attention, c) for c in counts] == before


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape",  # (B, T, N, H, dh): small, ragged with dh 32, serving shape
    [(2, 4, 64, 2, 64), (1, 3, 49, 4, 32), (2, 16, 256, 16, 64)],
)
@pytest.mark.parametrize("mode", ["space", "time"])
def test_cuda_quant_out_kernel_matches_plain(cuda_device, mode, shape, dtype):
    """K3 on the card: codes and scales against the plain version on the
    same inputs (at most 0.1% of the codes differ, by 1), and the CLS
    partials exactly those of K1/K2."""
    b, t, n, heads, dh = shape
    d = heads * dh
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(b, t, n, 3 * d, generator=g, device=cuda_device).to(dt)
    ck, cv, cq = (torch.randn(b, d, generator=g, device=cuda_device).to(dt) for _ in range(3))
    (q, s), parts = da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=heads, quant_out=True)
    _, parts0 = da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=heads)
    want = da.divided_patch_attention_ref(qkv, ck, cv, cq, mode=mode, heads=heads, quant_out=True)[0]
    torch.cuda.synchronize()
    _assert_codes_close((q.cpu().numpy(), s.cpu().numpy()),
                        (want[0].cpu().numpy(), want[1].cpu().numpy()), max_changed=1e-3)
    for a, b_ in zip(parts, parts0):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)
