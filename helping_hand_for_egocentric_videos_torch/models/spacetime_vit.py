"""SpaceTimeTransformer (TimeSformer, 'frozen-in-time' style) in PyTorch.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/models/spacetime_vit.py``.
The frozen LaviLa visual tower: a ViT with divided space-time attention
over ``1 + T*N`` tokens (CLS + T frames x N patches):

- one projection set (``VarAttention``) serves both the time and the space
  attention; the CLS query attends to all tokens, patch queries within
  their patch tube (time) or frame (space), with the CLS key/value
  prepended to every group;
- block: time-attn on norm3(x) -> time_residual = x + out; space-attn on
  norm1(time_residual); 'frozen-in-time' residual space_residual = **x** +
  space_out; QuickGELU MLP on norm2 (CLIP-initialised towers);
- channel-last input (B, T, H, W, C); the patchifier is a flat
  (P*P*C, D) matmul without bias; ``ln_pre`` (eps 1e-5) before the blocks,
  the block norms and the final norm use eps 1e-6.

The CLS token is carried apart from the patch tokens through the tower
(LayerNorm and MLP are per token, so the math is unchanged). With
``attention_backend="kernel"`` the attention runs through
``ops.divided_attention.divided_patch_attention`` (the CUDA kernel on the
card); ``"reference"`` runs ``_var_attention``, plain attention over the
concatenated sequence, as the oracle.

Int8 (a tower from ``quant.quantize_lavila_params``): ``linear`` takes the
int8 matmul on every ``QuantLinear``. With the kernel backend and a pure
int8 block (no fallback flag ``q_on``), the patch stream takes the fused
route of the JAX package (its ``_block`` and ``_var_attention_pallas``):
LayerNorm->int8 (K4) -> int8 qkv -> attention with its output quantized
(K3) -> int8 proj, and LayerNorm->int8 -> int8 fc1 -> QuickGELU->int8 (K5)
-> int8 fc2, so each matmul takes codes a kernel made. The fused route
quantizes the f32 LayerNorm, GELU and attention outputs; the unfused
route (``int8_linear``, the reference backend, every fallback tower)
quantizes the activation after its rounding to the stream's type. The two
round differently, so each backend takes the route its JAX counterpart
takes. The CLS row always goes through ``linear``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.act_quant import layer_norm_int8, quick_gelu_int8
from ..ops.divided_attention import divided_patch_attention, merge_cls_partials
from .layers import layer_norm, layer_norm_init, linear, linear_init, quick_gelu
from .quant import QuantLinear, int8_linear_prequant

__all__ = ["SpaceTimeConfig", "SpaceTimeViT", "spacetime_forward", "patchify"]

_BACKENDS = ("kernel", "reference")


@dataclass(frozen=True)
class SpaceTimeConfig:
    img_size: int = 224
    patch_size: int = 14
    in_chans: int = 3
    width: int = 1024
    depth: int = 24
    heads: int = 16
    mlp_ratio: int = 4
    num_frames: int = 4
    ln_eps: float = 1e-6  # timm default eps for TimeSformer norms
    attention_backend: str = "kernel"  # or "reference" (the eager oracle)

    @property
    def patches_per_frame(self) -> int:
        return (self.img_size // self.patch_size) ** 2


class VarAttention(nn.Module):
    """Packed qkv + out projection. ``zero_init`` reproduces
    time_init='zeros': qkv zeroed, proj weight filled with 1."""

    def __init__(self, dim: int, *, zero_init: bool, generator=None, device=None):
        super().__init__()
        kw = {"generator": generator, "device": device}
        self.qkv = linear_init(dim, 3 * dim, **kw)
        self.proj = linear_init(dim, dim, **kw)
        if zero_init:
            with torch.no_grad():
                self.qkv.weight.zero_()
                self.qkv.bias.zero_()
                self.proj.weight.fill_(1.0)
                self.proj.bias.zero_()


class SpaceTimeBlock(nn.Module):
    def __init__(self, cfg: SpaceTimeConfig, *, generator=None, device=None):
        super().__init__()
        kw = {"generator": generator, "device": device}
        dim, hidden = cfg.width, cfg.width * cfg.mlp_ratio
        self.norm1 = layer_norm_init(dim, device)
        self.attn = VarAttention(dim, zero_init=False, **kw)
        self.norm3 = layer_norm_init(dim, device)
        self.timeattn = VarAttention(dim, zero_init=True, **kw)
        self.norm2 = layer_norm_init(dim, device)
        self.mlp_fc1 = linear_init(dim, hidden, **kw)
        self.mlp_fc2 = linear_init(hidden, dim, **kw)


class SpaceTimeViT(nn.Module):
    """Parameters of the visual tower (mirrors ``init_spacetime_params``);
    the forward is ``spacetime_forward``."""

    def __init__(self, cfg: SpaceTimeConfig, *, generator=None, device=None):
        super().__init__()
        kw = {"generator": generator, "device": device}
        patch_dim = cfg.patch_size * cfg.patch_size * cfg.in_chans
        self.patch_embed = linear_init(patch_dim, cfg.width, bias=False, std=0.02, **kw)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.width, device=device))
        self.pos_embed = nn.Parameter(
            torch.randn(1, cfg.patches_per_frame + 1, cfg.width, device=device, generator=generator) * 0.02
        )
        self.temporal_embed = nn.Parameter(torch.zeros(1, cfg.num_frames, cfg.width, device=device))
        self.ln_pre = layer_norm_init(cfg.width, device)
        self.blocks = nn.ModuleList(SpaceTimeBlock(cfg, **kw) for _ in range(cfg.depth))
        self.norm = layer_norm_init(cfg.width, device)


def _attend(q, k, v):
    """softmax(q k^T) v with an f32 softmax; q is pre-scaled."""
    probs = torch.softmax((q @ k.transpose(-1, -2)).float(), dim=-1).to(q.dtype)
    return probs @ v


def _var_attention(p: VarAttention, x, t: int, n: int, heads: int, mode: str):
    """Plain attention over the full (B, 1 + T*N, D) tokens (the oracle)."""
    b, seq, d = x.shape
    dh = d // heads
    q, k, v = (
        z.reshape(b, seq, heads, dh).transpose(1, 2)  # (B, H, S, dh)
        for z in linear(p.qkv, x).chunk(3, dim=-1)
    )
    q = q * (dh**-0.5)
    cls_q, q_ = q[:, :, :1], q[:, :, 1:]
    cls_k, k_ = k[:, :, :1], k[:, :, 1:]
    cls_v, v_ = v[:, :, :1], v[:, :, 1:]

    cls_out = _attend(cls_q, k, v)  # the CLS query attends over everything

    if mode == "space":  # groups of one frame
        grp = t

        def reshape(z):
            return z.reshape(b, heads, t, n, dh)

        def unshape(z):
            return z.reshape(b, heads, t * n, dh)
    else:  # groups of one patch tube
        grp = n

        def reshape(z):
            return z.reshape(b, heads, t, n, dh).transpose(2, 3)

        def unshape(z):
            return z.transpose(2, 3).reshape(b, heads, t * n, dh)

    kg = torch.cat([cls_k[:, :, None].expand(b, heads, grp, 1, dh), reshape(k_)], dim=3)
    vg = torch.cat([cls_v[:, :, None].expand(b, heads, grp, 1, dh), reshape(v_)], dim=3)
    out = unshape(_attend(reshape(q_), kg, vg))
    out = torch.cat([cls_out, out], dim=2)  # (B, H, S, dh)
    out = out.transpose(1, 2).reshape(b, seq, d)
    return linear(p.proj, out)


def _pure_int8(lin) -> bool:
    """An int8 matmul without the fallback flag: the fused route's input."""
    return isinstance(lin, QuantLinear) and lin.q_on is None


def _var_attention_split(p: VarAttention, x_cls, x_p, t: int, n: int, heads: int, mode: str, backend: str):
    """Divided attention on the split (cls, patches) representation.

    ``x_p`` is the (B, T*N, D) patch stream, or on the fused int8 route its
    (codes, scales) from ``layer_norm_int8``. Returns (cls_out (B, 1, D),
    patch_out (B, T*N, D)), after the output projection. The patch qkv
    matmul's (B, T*N, 3D) output reshapes for free into the kernel's
    (B, T, N, 3D) input.
    """
    if backend == "reference":
        out = _var_attention(p, torch.cat([x_cls, x_p], dim=1), t, n, heads, mode)
        return out[:, :1], out[:, 1:]
    if backend != "kernel":
        raise ValueError(f"attention_backend must be one of {_BACKENDS}, got {backend!r}")
    if isinstance(x_p, tuple):  # codes and scales from layer_norm_int8
        x_q, s_x = x_p
        b, _, d = x_q.shape
        qkv_p = int8_linear_prequant(p.qkv, x_q, s_x, out_dtype=x_cls.dtype)
    else:
        b, _, d = x_p.shape
        qkv_p = linear(p.qkv, x_p)
    qkv_p = qkv_p.reshape(b, t, n, 3 * d)
    cls_q, cls_k, cls_v = (z.contiguous() for z in linear(p.qkv, x_cls)[:, 0].split(d, dim=-1))
    # a pure int8 proj takes the attention output as codes (K3)
    quant_out = _pure_int8(p.proj)
    out_patch, (m, s, co) = divided_patch_attention(
        qkv_p, cls_k, cls_v, cls_q, mode=mode, heads=heads, quant_out=quant_out
    )
    cls_out = merge_cls_partials(m, s, co, cls_q, cls_k, cls_v, heads).to(x_cls.dtype)[:, None, :]
    if quant_out:
        out_q, s_o = out_patch
        patch_out = int8_linear_prequant(
            p.proj, out_q.reshape(b, t * n, d), s_o.reshape(b, t * n, 1), out_dtype=x_cls.dtype
        )
    else:
        patch_out = linear(p.proj, out_patch.reshape(b, t * n, d))
    return linear(p.proj, cls_out), patch_out


def _block(p: SpaceTimeBlock, x, cfg: SpaceTimeConfig, t: int, n: int):
    """One block on the split (x_cls, x_p) representation."""
    eps = cfg.ln_eps
    be = cfg.attention_backend
    x_cls, x_p = x
    # the fused int8 route of the patch stream (module docstring)
    q_attn = be == "kernel" and _pure_int8(p.timeattn.qkv) and _pure_int8(p.attn.qkv)
    q_mlp = be == "kernel" and _pure_int8(p.mlp_fc1) and _pure_int8(p.mlp_fc2)

    def norm_patch(norm, z):
        return layer_norm_int8(norm, z, eps) if q_attn else layer_norm(norm, z, eps)

    tc, tp = _var_attention_split(
        p.timeattn, layer_norm(p.norm3, x_cls, eps), norm_patch(p.norm3, x_p),
        t, n, cfg.heads, "time", be,
    )
    tr_cls, tr_p = x_cls + tc, x_p + tp

    sc, sp = _var_attention_split(
        p.attn, layer_norm(p.norm1, tr_cls, eps), norm_patch(p.norm1, tr_p),
        t, n, cfg.heads, "space", be,
    )
    # 'frozen-in-time' residual: from x, not from the time residual
    sr_cls, sr_p = x_cls + sc, x_p + sp

    def mlp(z):
        h = layer_norm(p.norm2, z, eps)
        return z + linear(p.mlp_fc2, quick_gelu(linear(p.mlp_fc1, h)))

    def mlp_patch(z):
        if not q_mlp:
            return mlp(z)
        h_q, h_s = layer_norm_int8(p.norm2, z, eps)
        a = int8_linear_prequant(p.mlp_fc1, h_q, h_s, out_dtype=z.dtype)
        g_q, g_s = quick_gelu_int8(a)
        return z + int8_linear_prequant(p.mlp_fc2, g_q, g_s, out_dtype=z.dtype)

    return mlp(sr_cls), mlp_patch(sr_p)


def patchify(params: SpaceTimeViT, cfg: SpaceTimeConfig, video):
    """(B, T, H, W, C) float -> (B, T*N, D) patch tokens."""
    b, t, h, w, c = video.shape
    p = cfg.patch_size
    gh, gw = h // p, w // p
    x = video.reshape(b, t, gh, p, gw, p, c).permute(0, 1, 2, 4, 3, 5, 6)
    return linear(params.patch_embed, x.reshape(b, t * gh * gw, p * p * c))


def spacetime_forward(params: SpaceTimeViT, cfg: SpaceTimeConfig, video, *, dtype=torch.bfloat16):
    """Forward pass.

    Args:
        video: (B, T, H, W, C) float, already normalised; T may be any
            value up to the temporal-embedding length.
        dtype: the working type of the residual stream and the weights.
    Returns:
        (cls (B, D), tokens (B, 1+T*N, D)), both after the final LayerNorm,
        which runs in f32; f32 outputs.
    """
    b, t = video.shape[:2]
    n = cfg.patches_per_frame
    x_p = patchify(params, cfg, video.to(dtype))  # (B, T*N, D)
    x_cls = params.cls_token.to(dtype).expand(b, 1, cfg.width)

    pos_spatial = params.pos_embed[:, 1:, :].to(dtype).repeat(1, t, 1)  # (1, T*N, D)
    pos_temporal = params.temporal_embed[:, :t, :].to(dtype).repeat_interleave(n, dim=1)
    x_p = x_p + (pos_spatial + pos_temporal)
    x_cls = x_cls + params.pos_embed[:, :1, :].to(dtype)
    # ln_pre is a default nn.LayerNorm (eps 1e-5), unlike the 1e-6 block norms
    x_cls = layer_norm(params.ln_pre, x_cls, 1e-5)
    x_p = layer_norm(params.ln_pre, x_p, 1e-5)

    for blk in params.blocks:
        x_cls, x_p = _block(blk, (x_cls, x_p), cfg, t, n)

    x = torch.cat([x_cls, x_p], dim=1)
    x = layer_norm(params.norm, x.float(), cfg.ln_eps)
    return x[:, 0], x
