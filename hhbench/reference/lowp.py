"""The reference's matrix products in lower precisions, for the controls
(``CONTROLS``: each names the part of the model whose linear layers run
in that precision; the rest stays in full float32):

- ``fp8_linear`` rounds both operands to float8 e4m3 with one scale a
  tensor (the amax over 448, the recipe of Hopper's fp8 GEMMs) and
  accumulates their products in float32;
- ``bf16_linear`` computes the product in bfloat16, as an autocast or a
  cast of the part would, its gradients too;
- ``tf32_linear`` computes the product, and its gradients, with TF32
  allowed: the step below the configuration's float32 with TF32 off.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def _fp8(x):
    scale = x.abs().amax().clamp_min(1e-12) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_linear(x, weight, bias=None):
    return F.linear(_fp8(x), _fp8(weight), bias)


def bf16_linear(x, weight, bias=None):
    b = None if bias is None else bias.bfloat16()
    return F.linear(x.bfloat16(), weight.bfloat16(), b).float()


@contextlib.contextmanager
def _tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class _TF32Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        with _tf32():
            return F.linear(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        with _tf32():
            gx = g @ weight
            gw = g.reshape(-1, g.shape[-1]).t() @ x.reshape(-1, x.shape[-1])
        gb = g.reshape(-1, g.shape[-1]).sum(0) if ctx.has_bias else None
        return gx, gw, gb


def tf32_linear(x, weight, bias=None):
    return _TF32Linear.apply(x, weight, bias)


# control name -> {part: matrix product}; parts: "visual", "text", "decoder"
CONTROLS = {
    "ref_fp8": {"visual": fp8_linear},
    "ref_tf32_decoder": {"decoder": tf32_linear},
    "ref_bf16_decoder": {"decoder": bf16_linear},
    "ref_tf32_text": {"text": tf32_linear},
    "ref_bf16_text": {"text": bf16_linear},
}
