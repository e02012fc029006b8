"""The port's TimeSformer tower against the JAX ``spacetime_forward``.

Sizes as in ``tests/test_models.py::test_backbone_pallas_interpret_matches_xla``
(img 112, patch 14, width 128, heads 2, depth 2), at T=4 and T=16. The
JAX side runs through the Pallas kernel in interpret mode and through its
XLA path; the port through its kernel wrapper (the plain version on the
CPU) and through its eager oracle. Time attention is given random weights:
its zero init would feed the attention zeros. All in f32.

Int8: the tower quantized by the JAX ``quantize_lavila_params`` and carried
across by the bridge (the same codes). The pure int8 tower on the port's
kernel backend (the fused route: K4 -> int8 qkv -> K3 -> int8 proj, K4 ->
fc1 -> K5 -> fc2) is held against the JAX ``pallas_interpret`` path, which
takes the same route; the port's reference backend and the fallback
tower against the JAX ``xla`` path. Tolerance 1e-2 x max|out|: the routes
agree op by op, but the f32 sums run in another order, so a value on a
rounding boundary now and then takes the neighbouring int8 code, and
through the attention one such code touches every later token (measured
on the CPU: at most 0.35% of max|out|).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from helping_hand_for_egocentric_videos_tpu.models.quant import quantize_lavila_params
from helping_hand_for_egocentric_videos_tpu.models.spacetime_vit import (
    SpaceTimeConfig as JaxConfig,
    init_spacetime_params,
    spacetime_forward as jax_forward,
)
from helping_hand_for_egocentric_videos_torch.models import spacetime_vit as tvit
from helping_hand_for_egocentric_videos_torch.models.quant import QuantLinear
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


INT8_RTOL = 1e-2  # of max|out|, see the module docstring
THRESHOLD = 4.0


def _int8_params(t, fallback: bool):
    """The JAX-quantized tower; with ``fallback``, 16x gamma outliers in
    block 0's norm2 send that block to its float matmuls."""
    jcfg, params, video = _params(t)
    params = jax.tree.map(np.array, params)
    if fallback:
        params["blocks"]["norm2"]["g"][0, :3] = 16.0
    q = quantize_lavila_params({"visual": params}, THRESHOLD if fallback else None)["visual"]
    return jcfg, jax.tree.map(np.asarray, q), video


def _port_int8(qparams, t, backend, video):
    cfg = SpaceTimeConfig(
        img_size=112, patch_size=14, width=128, depth=2, heads=2, num_frames=t,
        attention_backend=backend,
    )
    vit = load_jax_params(SpaceTimeViT(cfg), qparams)
    with torch.inference_mode():
        return spacetime_forward(vit, cfg, torch.from_numpy(video), dtype=torch.float32)


@pytest.mark.parametrize(
    "fallback, jax_backend, port_backend",
    [(False, "pallas_interpret", "kernel"), (False, "xla", "reference"),
     (True, "xla", "kernel"), (True, "xla", "reference")],
    ids=["pure-fused", "pure-unfused", "fallback-kernel", "fallback-reference"],
)
@pytest.mark.parametrize("t", [4, 16])
def test_int8_forward_matches_jax(t, fallback, jax_backend, port_backend):
    jcfg, qparams, video = _int8_params(t, fallback)
    want_cls, want_tok = jax_forward(
        qparams, replace(jcfg, attention_backend=jax_backend), jnp.asarray(video),
        use_remat=False, dtype=jnp.float32,
    )
    cls, tok = _port_int8(qparams, t, port_backend, video)
    want_tok = np.asarray(want_tok)
    atol = INT8_RTOL * float(np.abs(want_tok).max())
    assert np.isfinite(tok.numpy()).all()
    np.testing.assert_allclose(tok.numpy(), want_tok, atol=atol)
    np.testing.assert_allclose(cls.numpy(), np.asarray(want_cls), atol=atol)


@pytest.mark.parametrize("fallback", [False, True], ids=["pure", "fallback"])
def test_int8_kernel_backend_takes_the_fused_route_only_when_pure(monkeypatch, fallback):
    """Per block, the pure int8 tower runs K4 three times (norm3, norm1,
    norm2), K3 once per attention mode and K5 once; a tower with the
    fallback flag runs none of them, as in the JAX package."""
    calls = {"ln": 0, "gelu": 0, "quant_out": 0, "attention": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            if name == "attention" and kw.get("quant_out"):
                calls["quant_out"] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tvit, "layer_norm_int8", spy("ln", tvit.layer_norm_int8))
    monkeypatch.setattr(tvit, "quick_gelu_int8", spy("gelu", tvit.quick_gelu_int8))
    monkeypatch.setattr(tvit, "divided_patch_attention", spy("attention", tvit.divided_patch_attention))
    _, qparams, video = _int8_params(4, fallback)
    _port_int8(qparams, 4, "kernel", video)
    depth = 2
    want = {"ln": 0, "gelu": 0, "quant_out": 0} if fallback else \
        {"ln": 3 * depth, "gelu": depth, "quant_out": 2 * depth}
    assert {k: calls[k] for k in want} == want and calls["attention"] == 2 * depth


def test_int8_weights_stay_quantized_through_the_bridge():
    _, qparams, _ = _int8_params(4, False)
    cfg = SpaceTimeConfig(img_size=112, patch_size=14, width=128, depth=2, heads=2, num_frames=4)
    vit = load_jax_params(SpaceTimeViT(cfg), qparams)
    lin = vit.blocks[1].attn.qkv
    assert isinstance(lin, QuantLinear) and lin.q_on is None and lin.w_q.dtype == torch.int8
    np.testing.assert_array_equal(lin.w_q.numpy(), qparams["blocks"]["attn"]["qkv"]["w_q"][1].T)


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


# ---- the int8 route per attention mode at T = 128 (TimeSformer-L heads)
RT, RN, RH, RD = 128, 64, 16, 1024


@pytest.fixture(scope="module")
def route_tower():
    """One pure int8 block at TimeSformer-L heads and width (16 x 64), T =
    128, 64 patches; time attention given N(0, 0.05) weights."""
    cfg = JaxConfig(img_size=112, patch_size=14, width=RD, depth=1, heads=RH, num_frames=RT)
    params = jax.tree.map(np.array, init_spacetime_params(jax.random.PRNGKey(1), cfg))
    rng = np.random.default_rng(6)
    ta = params["blocks"]["timeattn"]
    for name in ("qkv", "proj"):
        for k in ("w", "b"):
            ta[name][k] = (rng.normal(size=ta[name][k].shape) * 0.05).astype(np.float32)
    q = jax.tree.map(np.asarray, quantize_lavila_params({"visual": params}, None)["visual"])
    pcfg = SpaceTimeConfig(img_size=112, patch_size=14, width=RD, depth=1, heads=RH, num_frames=RT)
    x = rng.normal(size=(1, 1 + RT * RN, RD)).astype(np.float32)
    return q, pcfg, load_jax_params(SpaceTimeViT(pcfg), q), x


def test_int8_route_at_t128_unfused_time_fused_space(monkeypatch, route_tower):
    """The JAX ``_block`` fuses a mode only where its TPU kernel takes the
    shape (``_kernel_friendly``): at T = 128 its time attention goes to
    XLA with ``int8_linear`` for qkv and proj, while space attention and
    the MLP stay fused. The port's kernel backend must do the same: K4
    only for norm1 and norm2, K3 (``quant_out``) only in space mode, K5
    once, and ``int8_linear`` for the time qkv and proj (patch and CLS
    rows) and the CLS row's space qkv, proj and MLP."""
    _, cfg, vit, x = route_tower
    from helping_hand_for_egocentric_videos_torch.models import layers

    calls = {"ln": 0, "gelu": 0, "int8_linear": 0, "attention": []}

    def spy(name, fn):
        def wrapped(*a, **kw):
            if name == "attention":
                calls[name].append((kw["mode"], kw.get("quant_out", False)))
            else:
                calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tvit, "layer_norm_int8", spy("ln", tvit.layer_norm_int8))
    monkeypatch.setattr(tvit, "quick_gelu_int8", spy("gelu", tvit.quick_gelu_int8))
    monkeypatch.setattr(tvit, "divided_patch_attention", spy("attention", tvit.divided_patch_attention))
    monkeypatch.setattr(layers, "int8_linear", spy("int8_linear", layers.int8_linear))
    assert not tvit._kernel_friendly(RN, RD, RH, RT, "time") and tvit._kernel_friendly(RN, RD, RH, RT, "space")
    xc, xp = torch.from_numpy(x[:, :1]), torch.from_numpy(x[:, 1:])
    with torch.inference_mode():
        oc, op = tvit._block(vit.blocks[0], (xc, xp), cfg, RT, RN)
    assert op.shape == (1, RT * RN, RD) and torch.isfinite(op).all() and torch.isfinite(oc).all()
    assert calls == {"ln": 2, "gelu": 1, "int8_linear": 8,
                     "attention": [("time", False), ("space", True)]}


def test_int8_time_attention_at_t128_matches_jax_var_attention(route_tower):
    """The port's time attention on that route against the JAX
    ``_var_attention`` (the XLA route the JAX ``_block`` takes there) on
    the same quantized weights, in f32, to ``INT8_RTOL`` x max|out|.
    Measured on the CPU: 0.12% of max|out| at most, 2e-6 on average. The
    old fused route (K4 codes -> int8 qkv -> K3 -> prequantized proj) was
    off by the same amount here: in f32 both routes quantize the same f32
    values; they part in bf16, where the unfused route quantizes the
    bf16-rounded activation. So the route itself is shown by the spies of
    the test above."""
    q, _, vit, x = route_tower
    from helping_hand_for_egocentric_videos_tpu.models.spacetime_vit import _var_attention

    pq = jax.tree.map(lambda a: a[0], q["blocks"]["timeattn"])
    want = np.asarray(_var_attention(pq, jnp.asarray(x), RT, RN, RH, "time"))
    xc, xp = torch.from_numpy(x[:, :1]), torch.from_numpy(x[:, 1:])
    with torch.inference_mode():
        oc, op = tvit._var_attention_split(vit.blocks[0].timeattn, xc, xp, RT, RN, RH, "time", "kernel",
                                           kernel_route=False)
    got = torch.cat([oc, op], dim=1).numpy()
    np.testing.assert_allclose(got, want, atol=INT8_RTOL * float(np.abs(want).max()))
