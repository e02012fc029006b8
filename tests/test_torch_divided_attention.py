"""Divided attention of the PyTorch port against the JAX package.

The port's plain version plus ``merge_cls_partials`` is held, in f32,
against the JAX Pallas kernel run in interpret mode plus its merge, and
against the JAX eager oracle ``_var_attention``; with ``quant_out`` (K3)
its codes and scales against the JAX kernel's ``quant_out`` with the
JAX package's tolerances for quantized outputs. K6 (the head-grid time
kernel of long clips) has its plain version held against the JAX
``_time_attention_headgrid`` in interpret mode at T = 128, and the TPU
route thresholds the port copies (``_temporal_block``, ``_scoped_vmem_ask``,
``needs_head_grid``, ``_kernel_friendly``) equal the JAX package's. The
CUDA kernels against the plain versions run only where there is a card
(marker ``cuda``); the machine with the card has no JAX, so JAX comes in
through a fixture and this file runs there with
``python -m pytest --noconftest -m cuda tests/test_torch_divided_attention.py``.
"""

import types

import numpy as np
import pytest
import torch

from helping_hand_for_egocentric_videos_torch.models import spacetime_vit as tvit
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

    from helping_hand_for_egocentric_videos_tpu.models.spacetime_vit import _kernel_friendly

    return types.SimpleNamespace(jnp=jnp, da=divided_attention, var_attention=_var_attention,
                                 kernel_friendly=_kernel_friendly)


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


BF16_TOL = 2e-2  # the card's bf16 tolerance (chip_smoke.py, test_cuda_kernel_matches_plain)


@pytest.mark.parametrize("t", [4, 16])
@pytest.mark.parametrize("mode", ["space", "time"])
def test_ref_on_bf16_inputs_matches_jax_bf16_kernel_interpret(jx, mode, t):
    """On the same bf16 inputs (seeded N(0, 1)), the port's plain version
    (f32 arithmetic, output rounded to bf16) against the JAX kernel in
    bf16, which rounds the probabilities to bf16 before P V as the card's
    kernels do: the patch output and the merged CLS output within the
    card's bf16 tolerance of 2e-2. Largest errors seen: patch output
    0.0039 (space) and 0.0156 (time, t = 4), one bf16 step of the output;
    merged CLS output 4.8e-4. So the card's gate is as loose as the JAX
    kernel's own bf16 rounding, and no looser than one step of it."""
    jnp, jax_da = jx.jnp, jx.da
    rng = np.random.default_rng(7)
    qkv = jnp.asarray(rng.normal(size=(B, t, N, 3 * D)).astype(np.float32)).astype(jnp.bfloat16)
    cq, ck, cv = (jnp.asarray(rng.normal(size=(B, D)).astype(np.float32)).astype(jnp.bfloat16)
                  for _ in range(3))
    out, parts = jax_da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=HEADS, interpret=True)
    want_cls = jax_da.merge_cls_partials(*parts, cq, ck, cv, HEADS)
    assert out.dtype == jnp.bfloat16
    tq, tk, tv, tqkv = (torch.from_numpy(np.array(z.astype(jnp.float32))).to(torch.bfloat16)
                        for z in (cq, ck, cv, qkv))
    got, got_parts = da.divided_patch_attention_ref(tqkv, tk, tv, tq, mode=mode, heads=HEADS)
    got_cls = da.merge_cls_partials(*got_parts, tq, tk, tv, HEADS)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(out.astype(jnp.float32)), rtol=0, atol=BF16_TOL)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), rtol=0, atol=BF16_TOL)


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


# K6's CPU cases: T = 128 at N <= 64 keeps Tier-1 fast
HG_HEADS, HG_DH, HG_N = 2, 32, 16
HG_D = HG_HEADS * HG_DH


def _hg_inputs(b, t, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, t, HG_N, 3 * HG_D)).astype(np.float32)
    cq, ck, cv = (rng.normal(size=(b, HG_D)).astype(np.float32) for _ in range(3))
    return qkv, cq, ck, cv


def _group_partials(m, s, co, nb):
    """Per-tube partials (B, N, H, .) merged into groups of ``nb`` tubes:
    the TPU kernel's grouping."""
    b, n, h, _ = m.shape
    m, s, co = (z.reshape(b, n // nb, nb, h, -1) for z in (m, s, co))
    mg = m.amax(2, keepdim=True)
    w = torch.exp(m - mg)
    return mg[:, :, 0], (s * w).sum(2), (co * w).sum(2)


@pytest.mark.parametrize("b, t", [(1, 128), (2, 16)])
def test_headgrid_ref_matches_jax_headgrid_interpret(jx, b, t):
    """The plain K6 against the JAX head-grid kernel in interpret mode: the
    output and the merged CLS output at atol 1e-5; the partials, merged
    into the TPU's groups of ``_temporal_block(T, N)`` tubes, at rtol and
    atol 1e-5 (s sums up to T * nb terms)."""
    jnp, jax_da = jx.jnp, jx.da
    qkv, cq, ck, cv = _hg_inputs(b, t, seed=3)
    out, (m, s, co) = jax_da._time_attention_headgrid(
        jnp.asarray(qkv), jnp.concatenate([jnp.asarray(z) for z in (cq, ck, cv)], -1),
        heads=HG_HEADS, interpret=True,
    )
    want_cls = jax_da.merge_cls_partials(m, s, co, *(jnp.asarray(z) for z in (cq, ck, cv)), HG_HEADS)
    tq, tk, tv = (torch.from_numpy(z) for z in (cq, ck, cv))
    got, parts = da.time_attention_headgrid_ref(torch.from_numpy(qkv), tk, tv, tq, heads=HG_HEADS)
    assert parts[0].shape == (b, HG_N, HG_HEADS, 1) and parts[2].shape == (b, HG_N, HG_HEADS, HG_DH)
    got_cls = da.merge_cls_partials(*parts, tq, tk, tv, HG_HEADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=ATOL)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls), atol=ATOL)
    nb = jax_da._temporal_block(t, HG_N)
    for a, w in zip(_group_partials(*parts, nb), (m, s, co)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("b, t", [(1, 128), (2, 16)])
def test_headgrid_ref_matches_jax_var_attention(jx, b, t):
    """With an identity output projection, the JAX eager oracle gives the
    raw attention of every patch row and of the CLS row."""
    jnp = jx.jnp
    rng = np.random.default_rng(4)
    x = rng.normal(size=(b, 1 + t * HG_N, HG_D)).astype(np.float32)
    w = (rng.normal(size=(HG_D, 3 * HG_D)) * HG_D**-0.5).astype(np.float32)
    bias = (rng.normal(size=(3 * HG_D,)) * 0.1).astype(np.float32)
    p = {
        "qkv": {"w": jnp.asarray(w), "b": jnp.asarray(bias)},
        "proj": {"w": jnp.eye(HG_D, dtype=jnp.float32), "b": jnp.zeros((HG_D,), jnp.float32)},
    }
    want = np.asarray(jx.var_attention(p, jnp.asarray(x), t, HG_N, HG_HEADS, "time"))
    qkv = (x @ w + bias).astype(np.float32)
    cq, ck, cv = (torch.from_numpy(np.ascontiguousarray(z)) for z in np.split(qkv[:, 0], 3, axis=-1))
    got, parts = da.time_attention_headgrid_ref(
        torch.from_numpy(qkv[:, 1:].reshape(b, t, HG_N, 3 * HG_D)), ck, cv, cq, heads=HG_HEADS
    )
    np.testing.assert_allclose(got.numpy().reshape(b, t * HG_N, HG_D), want[:, 1:], atol=ATOL)
    got_cls = da.merge_cls_partials(*parts, cq, ck, cv, HG_HEADS)
    np.testing.assert_allclose(got_cls.numpy(), want[:, 0], atol=ATOL)


GRID = [(t, n, h) for t in (4, 16, 32, 64, 128, 256) for n in (16, 64, 256) for h in (2, 12, 16)]


def test_tpu_route_thresholds_equal_jax(jx):
    """The thresholds the port copies decide the JAX package's route; over
    the whole grid of (t, n, heads) they must give what the JAX ones give."""
    jax_da = jx.da
    for t, n, heads in GRID:
        r = t * jax_da._temporal_block(t, n)
        assert da._temporal_block(t, n) == jax_da._temporal_block(t, n), (t, n)
        assert da._scoped_vmem_ask(r, heads) == jax_da._scoped_vmem_ask(r, heads), (r, heads)
        assert da.needs_head_grid(t, n, heads) == jax_da.needs_head_grid(t, n, heads), (t, n, heads)
        for dh in (32, 64):
            for mode in ("space", "time"):
                args = (n, heads * dh, heads, t, mode)
                assert tvit._kernel_friendly(*args) == jx.kernel_friendly(*args), args
    # TimeSformer-L widths: the head grid at T = 128 and only there
    assert [da.needs_head_grid(t, 256, 16) for t in (16, 32, 64, 128)] == [False] * 3 + [True]


def test_wrapper_takes_the_head_grid_where_jax_does():
    """On the CPU the wrapper runs K6's plain version where the JAX package
    takes K6 (``needs_head_grid``) or where asked, with K6's per-tube
    partials; space mode and ``quant_out`` refuse it; nothing is counted."""
    qkv, cq, ck, cv = (torch.from_numpy(z) for z in _hg_inputs(1, 128, seed=5))
    counts = ("launches_time", "launches_time_headgrid")
    before = [getattr(da.divided_patch_attention, c) for c in counts]
    assert da.needs_head_grid(128, HG_N, 16) and not da.needs_head_grid(16, HG_N, 16)
    for head_grid in (None, True):
        got, parts = da.divided_patch_attention(qkv, ck, cv, cq, mode="time", heads=HG_HEADS,
                                                head_grid=head_grid)
        want, want_parts = da.time_attention_headgrid_ref(qkv, ck, cv, cq, heads=HG_HEADS)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        for a, b in zip(parts, want_parts):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="space"):
        da.divided_patch_attention(qkv, ck, cv, cq, mode="space", heads=HG_HEADS, head_grid=True)
    with pytest.raises(ValueError, match="quant_out"):
        da.divided_patch_attention(qkv, ck, cv, cq, mode="time", heads=HG_HEADS, head_grid=True,
                                   quant_out=True)
    assert [getattr(da.divided_patch_attention, c) for c in counts] == before


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_all_zero_time_attention_gives_exact_zeros(request, device, dtype):
    """Time attention bootstrapped from a stock CLIP checkpoint starts with
    its qkv weights and biases zero (``time_init='zeros'``), so K2 sees
    all-zero q, k, v and CLS rows: a uniform softmax over zero values
    must give exact zeros, with finite CLS partials that merge to zeros.
    At the bootstrap's train shape (16 clips of 4 frames, full width);
    the CPU case is the wrapper's plain version."""
    dev = request.getfixturevalue("cuda_device") if device == "cuda" else torch.device("cpu")
    b, t, n, heads, dh = (16, 4, 256, 16, 64) if device == "cuda" else (2, 4, 16, 4, 16)
    d = heads * dh
    dt = getattr(torch, dtype)
    qkv = torch.zeros(b, t, n, 3 * d, dtype=dt, device=dev)
    ck, cv, cq = (torch.zeros(b, d, dtype=dt, device=dev) for _ in range(3))
    before = da.divided_patch_attention.launches_time
    out, parts = da.divided_patch_attention(qkv, ck, cv, cq, mode="time", heads=heads)
    assert da.divided_patch_attention.launches_time == before + (device == "cuda")
    cls = da.merge_cls_partials(*parts, cq, ck, cv, heads)
    assert out.shape == (b, t, n, d) and out.dtype == dt
    assert not out.any() and not cls.any()
    assert all(torch.isfinite(part).all() for part in parts)


# (mode, (B, T, N, H, dh)) of K3's checks: small, ragged with dh 32 and the
# serving shape in both modes; then the models' other head counts (8, 12),
# the int8 loop's tubes (T = 4) and the long int8 path's frames (B = 2,
# T = 128)
QUANT_SHAPES = [
    (mode, shape) for mode in ("space", "time")
    for shape in ((2, 4, 64, 2, 64), (1, 3, 49, 4, 32), (2, 16, 256, 16, 64))
] + [
    ("space", (2, 4, 64, 8, 64)), ("time", (2, 16, 64, 8, 64)),
    ("space", (1, 4, 256, 12, 64)), ("time", (1, 16, 64, 12, 64)),
    ("time", (2, 4, 256, 16, 64)), ("space", (2, 128, 256, 16, 64)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode, shape", QUANT_SHAPES)
def test_cuda_quant_out_kernel_matches_plain(cuda_device, mode, shape, dtype):
    """K3 on the card: codes and scales against the plain version on the
    same inputs (at most 0.1% of the codes differ, by 1), the CLS partials
    exactly those of K1/K2, the call counted once."""
    b, t, n, heads, dh = shape
    d = heads * dh
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn(b, t, n, 3 * d, generator=g, device=cuda_device).to(dt)
    ck, cv, cq = (torch.randn(b, d, generator=g, device=cuda_device).to(dt) for _ in range(3))
    route = {"head_grid": False if mode == "time" else None}
    attr = f"launches_{mode}_quant"
    before = getattr(da.divided_patch_attention, attr)
    (q, s), parts = da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=heads, quant_out=True, **route)
    assert getattr(da.divided_patch_attention, attr) == before + 1
    _, parts0 = da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=heads, **route)
    want = da.divided_patch_attention_ref(qkv, ck, cv, cq, mode=mode, heads=heads, quant_out=True)[0]
    torch.cuda.synchronize()
    _assert_codes_close((q.cpu().numpy(), s.cpu().numpy()),
                        (want[0].cpu().numpy(), want[1].cpu().numpy()), max_changed=1e-3)
    for a, b_ in zip(parts, parts0):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape",  # (B, T, N, H, dh)
    [
        (1, 128, 256, 16, 64), (2, 128, 256, 16, 64),  # full width: more items than persistent blocks
        (1, 128, 4, 2, 64),  # 8 items: fewer items than blocks
        (1, 37, 8, 4, 64), (1, 100, 8, 4, 64), (1, 256, 4, 2, 64),  # ragged T, the largest T
        (2, 1, 16, 4, 64), (2, 16, 256, 16, 64),  # forced at one frame and at 16
        (2, 128, 16, 2, 32), (1, 37, 8, 4, 32),  # dh 32
        (1, 128, 13, 4, 64),  # N not a multiple of 8
        (2, 64, 8, 1, 32),  # D = 32: the narrowest row, 192 bytes of qkv a token
    ],
)
def test_cuda_headgrid_kernel_matches_plain(cuda_device, shape, dtype):
    """K6 on the card against its plain version: the patch output (f32:
    only the order of the sums differs; bf16: the probabilities enter P V
    in bf16 and the output is rounded), the partials' per-tube shape, the
    merged CLS output and one launch counted."""
    b, t, n, heads, dh = shape
    d = heads * dh
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    qkv = torch.randn(b, t, n, 3 * d, generator=g, device=cuda_device).to(dt)
    ck, cv, cq = (torch.randn(b, d, generator=g, device=cuda_device).to(dt) for _ in range(3))
    before = da.divided_patch_attention.launches_time_headgrid
    out, parts = da.divided_patch_attention(qkv, ck, cv, cq, mode="time", heads=heads, head_grid=True)
    assert da.divided_patch_attention.launches_time_headgrid == before + 1
    want, want_parts = da.time_attention_headgrid_ref(qkv, ck, cv, cq, heads=heads)
    cls = da.merge_cls_partials(*parts, cq, ck, cv, heads)
    want_cls = da.merge_cls_partials(*want_parts, cq, ck, cv, heads)
    torch.cuda.synchronize()
    assert out.dtype == dt and parts[0].shape == (b, n, heads, 1) and parts[1].shape == (b, n, heads, 1)
    assert parts[2].shape == (b, n, heads, dh)
    atol = 1e-4 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=atol)
    torch.testing.assert_close(cls, want_cls, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_headgrid_wrapper_raises_on_what_it_cannot_copy(cuda_device):
    """K6 copies qkv's rows and the CLS rows 16 bytes at a time: a qkv or a
    CLS row off a 16-byte boundary, or T above 256, raises and launches
    nothing."""
    b, t, n, heads, dh = 1, 16, 8, 2, 64
    d = heads * dh
    g = torch.Generator(device=cuda_device).manual_seed(5)
    flat = torch.randn(b * t * n * 3 * d + 8, generator=g, device=cuda_device).to(torch.bfloat16)
    cls = torch.randn(3 * b * d + 8, generator=g, device=cuda_device).to(torch.bfloat16)
    ck, cv, cq = (cls[i * d:(i + 1) * d].view(b, d) for i in range(3))
    before = da.divided_patch_attention.launches_time_headgrid
    bad_qkv = flat[1:1 + b * t * n * 3 * d].view(b, t, n, 3 * d)  # 2 bytes past a boundary
    with pytest.raises(ValueError, match="16-byte"):
        da.divided_patch_attention(bad_qkv, ck, cv, cq, mode="time", heads=heads, head_grid=True)
    qkv = flat[:b * t * n * 3 * d].view(b, t, n, 3 * d)
    bad_cq = cls[2 * d + 1:3 * d + 1].view(b, d)
    with pytest.raises(ValueError, match="16-byte"):
        da.divided_patch_attention(qkv, ck, cv, bad_cq, mode="time", heads=heads, head_grid=True)
    long = torch.zeros(b, 257, 1, 3 * d, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="T <= 256"):
        da.divided_patch_attention(long, ck, cv, cq, mode="time", heads=heads, head_grid=True)
    assert da.divided_patch_attention.launches_time_headgrid == before
    da.divided_patch_attention(qkv, ck, cv, cq, mode="time", heads=heads, head_grid=True)
    assert da.divided_patch_attention.launches_time_headgrid == before + 1


# (mode, (B, T, N, H, dh)) for K1's and K2's tensor-core tilings: ragged
# frames, frames too large for shared memory (N = 1024: streamed key tiles),
# tubes from one frame to 128 (several heads a block below 4 query tiles),
# a streamed tube (T = 1024), dh 32
TILINGS = [
    ("space", (1, 2, 49, 4, 64)), ("space", (1, 2, 196, 4, 64)), ("space", (1, 2, 257, 2, 64)),
    ("space", (1, 2, 1024, 2, 64)), ("space", (1, 2, 196, 4, 32)), ("space", (1, 1, 1024, 2, 32)),
    ("time", (2, 1, 16, 16, 64)), ("time", (1, 8, 16, 16, 64)), ("time", (1, 16, 32, 16, 64)),
    ("time", (1, 17, 16, 8, 64)), ("time", (1, 33, 8, 4, 64)), ("time", (1, 64, 8, 16, 64)),
    ("time", (1, 128, 8, 2, 64)), ("time", (1, 16, 16, 16, 32)), ("time", (1, 33, 8, 4, 32)),
    ("time", (1, 1024, 2, 2, 64)),
]


def _tiling_inputs(shape, dt, device, seed):
    b, t, n, heads, dh = shape
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, t, n, 3 * heads * dh, generator=g, device=device).to(dt)
    ck, cv, cq = (torch.randn(b, heads * dh, generator=g, device=device).to(dt) for _ in range(3))
    return qkv, ck, cv, cq


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode, shape", TILINGS)
def test_cuda_kernel_tilings_match_plain(cuda_device, mode, shape, dtype):
    """K1 and K2 (time attention forced onto K2) at the tilings above: the
    patch output at the card's tolerances (f32 1e-4, bf16 2e-2) and the
    merged CLS output at 1e-4; one launch counted."""
    heads = shape[3]
    dt = getattr(torch, dtype)
    qkv, ck, cv, cq = _tiling_inputs(shape, dt, cuda_device, seed=3)
    attr = f"launches_{mode}"
    before = getattr(da.divided_patch_attention, attr)
    out, parts = da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=heads,
                                            head_grid=False if mode == "time" else None)
    assert getattr(da.divided_patch_attention, attr) == before + 1
    want, want_parts = da.divided_patch_attention_ref(qkv, ck, cv, cq, mode=mode, heads=heads)
    cls = da.merge_cls_partials(*parts, cq, ck, cv, heads)
    want_cls = da.merge_cls_partials(*want_parts, cq, ck, cv, heads)
    torch.cuda.synchronize()
    assert out.dtype == dt and parts[0].shape == want_parts[0].shape
    atol = 1e-4 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=atol)
    torch.testing.assert_close(cls, want_cls, rtol=0, atol=1e-4)


# K3's tilings beyond K1/K2's: streamed frames at 16 heads, 12 heads over
# ragged frames and over 3-tile tubes
QUANT_TILINGS = TILINGS + [
    ("space", (1, 1, 1024, 16, 64)), ("space", (1, 2, 196, 12, 64)), ("time", (1, 33, 8, 12, 64)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode, shape", QUANT_TILINGS)
def test_cuda_quant_out_kernel_tilings_match_plain(cuda_device, mode, shape, dtype):
    """K3 at the same tilings: codes within 1 of the plain version's, at
    most 0.1% changed, scales within rtol 1e-5; CLS partials bit-equal to
    those of K1/K2 on the same inputs."""
    heads = shape[3]
    dt = getattr(torch, dtype)
    qkv, ck, cv, cq = _tiling_inputs(shape, dt, cuda_device, seed=4)
    route = {"head_grid": False if mode == "time" else None}
    (q, s), parts = da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=heads, quant_out=True, **route)
    _, parts0 = da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=heads, **route)
    want = da.divided_patch_attention_ref(qkv, ck, cv, cq, mode=mode, heads=heads, quant_out=True)[0]
    torch.cuda.synchronize()
    _assert_codes_close((q.cpu().numpy(), s.cpu().numpy()),
                        (want[0].cpu().numpy(), want[1].cpu().numpy()), max_changed=1e-3)
    for a, b_ in zip(parts, parts0):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)


def test_plain_route_on_cpu_is_differentiable():
    """On the CPU the wrapper runs the plain version, so gradients flow
    (the CUDA kernels have none and refuse inputs that require grad)."""
    _, _, _, qkv = _qkv_inputs(4)
    qkv_p, cls_q, cls_k, cls_v = (torch.from_numpy(z).requires_grad_() for z in _split(qkv, 4))
    out, parts = da.divided_patch_attention(qkv_p, cls_k, cls_v, cls_q, mode="space", heads=HEADS)
    (out.sum() + da.merge_cls_partials(*parts, cls_q, cls_k, cls_v, HEADS).sum()).backward()
    assert all(z.grad is not None and torch.isfinite(z.grad).all() for z in (qkv_p, cls_q, cls_k, cls_v))


@pytest.mark.cuda
@pytest.mark.parametrize("head_grid", [False, True])
def test_cuda_kernel_refuses_inputs_that_require_grad(cuda_device, head_grid):
    """The kernels have no backward: with grad mode on, an input that
    requires grad raises instead of leaving the graph; under no_grad the
    same call runs."""
    b, t, n, d = 1, 4, 64, 2 * 64
    qkv = torch.randn(b, t, n, 3 * d, device=cuda_device)
    ck, cv, cq = (torch.randn(b, d, device=cuda_device) for _ in range(3))
    kw = dict(mode="time", heads=2, head_grid=head_grid)
    with pytest.raises(RuntimeError, match="no backward"):
        da.divided_patch_attention(qkv.requires_grad_(), ck, cv, cq, **kw)
    with pytest.raises(RuntimeError, match="no backward"):
        da.divided_patch_attention(qkv.detach(), ck.requires_grad_(), cv, cq, **kw)
    with torch.no_grad():
        da.divided_patch_attention(qkv, ck, cv, cq, **kw)


# the zero-shot harnesses' batches (clips, frames) at TimeSformer-L widths: EgoMCQ 4 items x 5
# clips of 4 frames; EGTEA 10 windows of 16 frames, and times 6 crops (60 x 256 = 15360 tubes
# in the f32 route's grid)
HARNESS_SHAPES = [(20, 4), (10, 16), (60, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", HARNESS_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["space", "time"])
def test_cuda_kernel_matches_plain_at_harness_shapes(cuda_device, mode, shape, dtype):
    """K1 and K2 at the eval harnesses' batches, N = 256, H = 16, dh = 64:
    the patch output at the card's tolerances (f32 1e-4, bf16 2e-2), the
    merged CLS output at 1e-4, one launch counted."""
    b, t = shape
    dt = getattr(torch, dtype)
    qkv, ck, cv, cq = _tiling_inputs((b, t, 256, 16, 64), dt, cuda_device, seed=5)
    attr = f"launches_{mode}"
    before = getattr(da.divided_patch_attention, attr)
    out, parts = da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=16)
    assert getattr(da.divided_patch_attention, attr) == before + 1
    cls = da.merge_cls_partials(*parts, cq, ck, cv, 16)
    want, want_parts = da.divided_patch_attention_ref(qkv, ck, cv, cq, mode=mode, heads=16)
    want_cls = da.merge_cls_partials(*want_parts, cq, ck, cv, 16)
    torch.cuda.synchronize()
    atol = 1e-4 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=atol)
    torch.testing.assert_close(cls, want_cls, rtol=0, atol=1e-4)


def test_f32_route_refuses_a_grid_beyond_its_limit():
    """The f32 route holds a group a grid row (gridDim.z <= 65535): the
    wrapper refuses a larger batch with the clips that would fit, before
    any launch. 60 crops x 256 tubes (EGTEA's 6-crop batch) fits."""
    da.check_f32_groups(60, 16, 256, "time")
    da.check_f32_groups(255, 16, 256, "time")
    da.check_f32_groups(4095, 16, 256, "space")
    with pytest.raises(ValueError, match=r"at most 65535 groups \(B x patch tubes\), got 256 x 256 = 65536: "
                                         r"split the batch into at most 255 clips"):
        da.check_f32_groups(256, 16, 256, "time")
    with pytest.raises(ValueError, match=r"B x frames\), got 4096 x 16 = 65536"):
        da.check_f32_groups(4096, 16, 256, "space")


@pytest.mark.cuda
def test_cuda_wrapper_refuses_a_grid_beyond_its_limit(cuda_device):
    """On the card the f32 wrapper refuses 256 clips x 256 tubes before the
    launch (no launch counted); bf16 has no such limit."""
    qkv, ck, cv, cq = _tiling_inputs((256, 2, 256, 1, 64), torch.float32, cuda_device, seed=6)
    before = da.divided_patch_attention.launches_time
    with pytest.raises(ValueError, match="at most 65535 groups"):
        da.divided_patch_attention(qkv, ck, cv, cq, mode="time", heads=1)
    assert da.divided_patch_attention.launches_time == before
    out, _ = da.divided_patch_attention(*(z.to(torch.bfloat16) for z in (qkv, ck, cv, cq)), mode="time", heads=1)
    torch.cuda.synchronize()
    assert da.divided_patch_attention.launches_time == before + 1 and torch.isfinite(out.float()).all()
