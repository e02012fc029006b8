"""Int8 inference quantization of the frozen visual tower.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/models/quant.py``.
The tower's block matmuls (``attn``/``timeattn`` ``qkv``/``proj``,
``mlp_fc1``, ``mlp_fc2``) are weight-quantized once and
activation-quantized at use:

- weights: per-output-channel symmetric int8, ``s_w = max|w| / 127``
  floored at 1e-8, quantized from the f32 weights;
- activations: per-token dynamic symmetric int8 (``int8_linear``), or
  codes a kernel already made (``int8_linear_prequant``: the LayerNorm
  and QuickGELU kernels of ``ops/act_quant.py`` and the attention
  kernel's ``quant_out``);
- the int8 x int8 -> int32 product is ``torch._int_mm``, the int8
  counterpart of ``torch.matmul`` (the JAX package leaves it to XLA's
  ``dot_general``, outside any Pallas kernel), and the dequantization
  ``acc * s_x * s_w + b`` is plain torch in f32.

A quantized Linear is a ``QuantLinear``; ``layers.linear`` dispatches on
it, so the model code calls ``linear`` either way.

Mixed-precision fallback (``act_outlier_threshold``): each block gets an
activation-outlier score, the largest LayerNorm-gamma spread
(max|g| / median|g|) of its three norms; blocks above the threshold keep
their float matmuls. As in the JAX package, the flag ``q_on`` and the
float ``weight`` are kept on *every* block's QuantLinear as soon as one
block falls back, and then every matmul takes ``mixed_linear``, the
unfused route: the fused LayerNorm/QuickGELU/attention kernels run
nowhere (``spacetime_vit._pure_int8``).
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "QuantLinear",
    "quantize_linear_params",
    "quantize_lavila_params",
    "int8_linear",
    "int8_linear_prequant",
    "mixed_linear",
    "cast_floats",
]

# torch._int_mm on CUDA takes more than 16 rows; shorter inputs (the CLS
# stream has one row a clip) are padded with zero rows to this many
_MIN_ROWS = 32


class QuantLinear(nn.Module):
    """Int8 weights of one Linear, as buffers.

    ``w_q`` int8 (out, in), ``s_w`` f32 (out,), ``bias`` (out,) or None;
    with the fallback, also the float ``weight`` (out, in) and the bool
    scalar ``q_on`` (True: this block runs int8). ``s_w`` stays f32 when
    the tower is cast (``cast_floats``).
    """

    def __init__(self, w_q, s_w, bias=None, *, weight=None, q_on=None):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("s_w", s_w)
        self.register_buffer("bias", bias)
        self.register_buffer("weight", weight)
        self.register_buffer("q_on", q_on)


def quantize_linear_params(lin: nn.Linear) -> QuantLinear:
    """An ``nn.Linear`` -> a ``QuantLinear`` with per-channel symmetric int8
    weights quantized from its f32 weight."""
    w = lin.weight.detach().float()  # (out, in)
    s_w = torch.clamp_min(w.abs().amax(1) / 127.0, 1e-8)
    w_q = torch.clamp(torch.round(w / s_w[:, None]), -127, 127).to(torch.int8)
    bias = None if lin.bias is None else lin.bias.detach().clone()
    return QuantLinear(w_q, s_w, bias)


def _median(a):
    """Median over the last axis, the mean of the two middle values for an
    even count, as ``jnp.median`` ((lo + hi) * 0.5); ``torch.median``
    would return the lower one."""
    srt = a.sort(-1).values
    w = a.shape[-1]
    return (srt[..., (w - 1) // 2] + srt[..., w // 2]) * 0.5


def _gamma_spread(g):
    """Per-layer LN-gamma outlier score: max|g| / median|g| over channels;
    g (L, W) -> (L,)."""
    a = g.detach().float().abs()
    return a.amax(-1) / torch.clamp_min(_median(a), 1e-8)


def _quantize_stacked(lins, score=None, threshold: float | None = None) -> list[QuantLinear]:
    """Quantize one matmul family, one ``nn.Linear`` per block.

    With a ``threshold``, blocks whose outlier ``score`` (L,) exceeds it
    keep their float weight; if any does, every block's QuantLinear gets
    ``weight`` and its ``q_on`` flag (the JAX package stacks the flag over
    the blocks, so it is there for all or for none). The JAX function's
    weight-spread score for a missing ``score`` has no caller and is not
    ported: ``quantize_lavila_params`` always passes the gamma score."""
    qs = [quantize_linear_params(lin) for lin in lins]
    if threshold is not None:
        q_on = score <= threshold
        if not bool(q_on.all()):
            for q, lin, on in zip(qs, lins, q_on):
                q.weight = lin.weight.detach().clone()
                q.q_on = on.clone()
    return qs


def quantize_lavila_params(lavila, act_outlier_threshold: float | None = None):
    """A copy of the ``Lavila`` with the visual tower's block matmuls
    quantized; the text tower, the patch embedding and the norms stay as
    they are. ``act_outlier_threshold`` turns on the per-block fallback
    (module docstring). Quantize the f32 weights: cast afterwards, with
    ``cast_floats``."""
    out = copy.deepcopy(lavila)
    blocks = out.visual.blocks
    score = None
    if act_outlier_threshold is not None:
        # the block's score is the max spread over its three norms: outlier
        # channels a norm amplifies ride the block's whole residual stream
        score = torch.stack([
            _gamma_spread(torch.stack([getattr(b, name).weight for b in blocks]))
            for name in ("norm1", "norm2", "norm3")
        ]).amax(0)
    families = [(key, sub) for key in ("attn", "timeattn") for sub in ("qkv", "proj")]
    families += [(None, sub) for sub in ("mlp_fc1", "mlp_fc2")]
    for key, sub in families:
        owners = [b if key is None else getattr(b, key) for b in blocks]
        qs = _quantize_stacked([getattr(o, sub) for o in owners], score, act_outlier_threshold)
        for o, q in zip(owners, qs):
            setattr(o, sub, q)
    return out


def cast_floats(module: nn.Module, dtype) -> nn.Module:
    """A copy of ``module`` with its float parameters and buffers in
    ``dtype``, except the weight scales ``s_w`` of its QuantLinears, which
    stay f32 as in the JAX forward (so biases and fallback weights are
    rounded to ``dtype`` and the scales are not)."""
    out = copy.deepcopy(module).to(dtype)
    for src, dst in zip(module.modules(), out.modules()):
        if isinstance(dst, QuantLinear):
            dst.s_w = src.s_w.detach().float().clone()
    return out


def _int8_matmul(x_q, w_q):
    """(..., K) int8 @ (N, K)^T int8 -> (..., N) int32, through
    ``torch._int_mm`` on a (rows, K) view."""
    lead = x_q.shape[:-1]
    a = x_q.reshape(-1, x_q.shape[-1])
    m = a.shape[0]
    if m < _MIN_ROWS:
        a = torch.cat([a, a.new_zeros(_MIN_ROWS - m, a.shape[1])])
    acc = torch._int_mm(a, w_q.t())[:m]
    return acc.reshape(*lead, w_q.shape[0])


def _dequant(p: QuantLinear, acc, s_x, out_dtype):
    # scales kept f32 whatever the activation type
    y = acc.float() * s_x * p.s_w.float()
    if p.bias is not None:
        y = y + p.bias.float()
    return y.to(out_dtype)


def int8_linear(p: QuantLinear, x):
    """Dynamic-activation int8 matmul: y = (x_q @ w_q^T) * s_x * s_w + b.

    The abs-max is taken in the activation type (bf16 on the serving
    path; the max of bf16 values is exact), the quantization in f32."""
    s_x = torch.clamp_min(x.abs().amax(-1, keepdim=True).float() / 127.0, 1e-8)
    x_q = torch.clamp(torch.round(x.float() * (1.0 / s_x)), -127, 127).to(torch.int8)
    return _dequant(p, _int8_matmul(x_q, p.w_q), s_x, x.dtype)


def int8_linear_prequant(p: QuantLinear, x_q, s_x, out_dtype=torch.bfloat16):
    """Int8 matmul on an already quantized activation: codes x_q (..., K)
    int8 with per-token scales s_x (..., 1) f32."""
    return _dequant(p, _int8_matmul(x_q, p.w_q), s_x, out_dtype)


def mixed_linear(p: QuantLinear, x):
    """Per-block int8-or-float dispatch on ``p.q_on``. The flag is a
    tensor (it travels in the state dict), so reading it on the card
    synchronises; only the fallback route reads it."""
    if bool(p.q_on):
        return int8_linear(p, x)
    bias = None if p.bias is None else p.bias.to(x.dtype)
    return F.linear(x, p.weight.to(x.dtype), bias)
