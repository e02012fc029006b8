"""Fused activation -> per-row int8 quantization, with its CUDA kernels.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/ops/act_quant.py``.
On the int8 path every quantized matmul's input is a LayerNorm or a
QuickGELU output; these compute that op and its per-row symmetric int8
quantization in one pass, so the float activation is never written:

- ``layer_norm_int8`` (K4): LayerNorm with f32 statistics and affine, then
  int8 codes and per-row scales. Feeds the qkv and mlp_fc1 matmuls.
- ``quick_gelu_int8`` (K5): ``x * sigmoid(1.702 x)``, then the same.
  Feeds mlp_fc2.

The scale rule is ``quant.int8_linear``'s (``quantize_rows_ref``):
``s = max(max|y| / 127, 1e-8)``, ``q = clip(round(y * (1 / s)), -127,
127)`` with round half to even. The consumers are
``models.quant.int8_linear_prequant``.

Beside each wrapper is its plain PyTorch version (``*_ref``). A CPU tensor
runs the plain version; a CUDA tensor runs the kernel in
``csrc/act_quant.cu`` or the call raises. The kernels have no backward:
on a CUDA tensor a wrapper raises where grad mode is on and the
activation requires grad (the LayerNorm's parameters are read as
constants on both routes). Launches are counted in the integer attribute
``launches`` of each wrapper. ``layer_norm_plan`` reports the route and
launch shape K4 takes for a tensor's rows, on the card only.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import library

__all__ = [
    "quantize_rows_ref",
    "layer_norm_int8",
    "layer_norm_int8_ref",
    "quick_gelu_int8",
    "quick_gelu_int8_ref",
    "check_no_grad",
    "layer_norm_plan",
]

MAX_WIDTH = 4096  # the kernels hold a row in registers: 16 values a thread


def quantize_rows_ref(y):
    """(..., D) f32 -> (codes int8 (..., D), scales f32 (..., 1))."""
    s = torch.clamp_min(y.abs().amax(-1, keepdim=True) / 127.0, 1e-8)
    q = torch.clamp(torch.round(y * (1.0 / s)), -127, 127).to(torch.int8)
    return q, s


def layer_norm_int8_ref(p, x, eps: float = 1e-6):
    """Plain version of K4: LayerNorm ``p`` (weight, bias) in f32, then
    ``quantize_rows_ref``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return quantize_rows_ref(y * p.weight.detach().float() + p.bias.detach().float())


def quick_gelu_int8_ref(x):
    """Plain version of K5: QuickGELU in f32, then ``quantize_rows_ref``."""
    xf = x.float()
    return quantize_rows_ref(xf * torch.sigmoid(1.702 * xf))


def check_no_grad(name: str, *tensors):
    """Raise where grad mode is on and one of ``tensors`` requires grad: a
    kernel launched through ctypes has no backward, and its output would
    leave the autograd graph without a word."""
    if torch.is_grad_enabled() and any(z.requires_grad for z in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires grad; "
            "call it under torch.no_grad() (the backbone it serves is frozen)"
        )


def _check(x, name: str):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous activation")
    if not 1 <= x.shape[-1] <= MAX_WIDTH or x.numel() == 0:
        raise ValueError(f"{name} takes rows of 1..{MAX_WIDTH} values, got shape {tuple(x.shape)}")


def _outputs(x):
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    return codes, scales


_FNS: dict = {}


def _entry(name: str, nptr: int, *tail):
    """The kernel's C entry point with its argument types set, looked up
    once (the wrappers run many times a forward)."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(library("act_quant"), name)
        fn.argtypes = [ctypes.c_void_p] * nptr + list(tail)
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def layer_norm_int8(p, x, eps: float = 1e-6):
    """LayerNorm + per-row int8 quantization (K4).

    p: the ``nn.LayerNorm`` (weight, bias (D,)); x: (..., D).
    Returns (codes int8 (..., D), scales f32 (..., 1)).
    """
    if x.device.type == "cpu":
        return layer_norm_int8_ref(p, x, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no layer_norm_int8 kernel for device {x.device}")
    check_no_grad("layer_norm_int8", x)
    _check(x, "layer_norm_int8")
    d = x.shape[-1]
    g, b = (z.detach().float().contiguous() for z in (p.weight, p.bias))
    if g.device != x.device or g.shape != (d,) or b.shape != (d,):
        raise ValueError(f"LayerNorm params must be ({d},) on {x.device}")
    codes, scales = _outputs(x)
    fn = _entry("hh_layer_norm_int8", 5, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                x.numel() // d, d, eps, int(x.dtype == torch.bfloat16),
                torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "layer_norm_int8")
    layer_norm_int8.launches += 1
    return codes, scales


def quick_gelu_int8(x):
    """QuickGELU + per-row int8 quantization (K5): x (..., D) ->
    (codes int8 (..., D), scales f32 (..., 1))."""
    if x.device.type == "cpu":
        return quick_gelu_int8_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"no quick_gelu_int8 kernel for device {x.device}")
    check_no_grad("quick_gelu_int8", x)
    _check(x, "quick_gelu_int8")
    d = x.shape[-1]
    codes, scales = _outputs(x)
    fn = _entry("hh_quick_gelu_int8", 3, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), codes.data_ptr(), scales.data_ptr(), x.numel() // d, d,
                int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "quick_gelu_int8")
    quick_gelu_int8.launches += 1
    return codes, scales


def layer_norm_plan(x) -> dict:
    """K4's cut of the rows of the CUDA tensor x: its route (a warp a row,
    or a block a row), values a lane, blocks and threads a block."""
    d = x.shape[-1]
    fn = _entry("hh_layer_norm_int8_plan", 1, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_longlong))
    plan = (ctypes.c_longlong * 4)()
    if fn(x.data_ptr(), x.numel() // d, d, int(x.dtype == torch.bfloat16), plan):
        raise RuntimeError(f"no K4 plan for rows of {d}")
    route = ("warp_row", "block_row")[plan[0]]
    return {"route": route, "values_a_lane": plan[1], "blocks": plan[2], "threads_a_block": plan[3]}


layer_norm_int8.launches = 0
quick_gelu_int8.launches = 0
