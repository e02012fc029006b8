"""Kimi-VL's latent attention at a decode step (absorbed MLA), with the
hand-written softmax that merges a clip's prefix and a sequence's tail.

A step's query rows, (N, heads, D) with D = 512 + 64 (the query mapped
into the latent, then its rotary part), attend two caches at once: the
clip's prefix (clips, P, D), which its R = N / clips sequences share, and
the sequence's own tail (N, t, D). The values are each position's first
512 columns, the latent. One softmax over the P + t scores of a row
(scale ``1 / sqrt(192)``), then the weighted sums.

``attend`` computes it in five launches: the prefix's scores, a clip's R
x heads rows against its P positions as one (R heads, P) product, and the
tail's, each a batched bf16 GEMM with an f32 output; the merged softmax
(``latent_softmax``); the two weighted sums, the tail's added onto the
prefix's. On a CUDA tensor the softmax is the kernel in
``csrc/latent_softmax.cu`` (``hh_latent_softmax``: a warp a row, the max,
the sum of ``exp2((s - max) * scale * log2 e)`` and the bf16
probabilities, in f32), which raises on what it does not take; on a CPU
tensor the plain version (``latent_softmax_ref``), the same in float32.
A profile reads the attention's kernels as the softmax kernel and the two
GEMMs on each side of it (``hhbench/metrics/latent_attn_roofline.kimivl.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import library

__all__ = ["attend", "latent_softmax", "latent_softmax_ref"]

_LOG2E = 1.4426950408889634


def _bmm_f32(a, b):
    """``a @ b`` with f32 output: on the card the product of the bf16
    operands accumulated and written in f32."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def latent_softmax_ref(s_pre, s_tail, scale: float, dtype):
    """Plain version: (R, P) and (R, t) f32 scores -> their probabilities
    under one softmax of ``scale`` times the P + t scores of a row, in
    ``dtype``."""
    p = torch.softmax(torch.cat([s_pre, s_tail], dim=-1).float() * scale, dim=-1).to(dtype)
    return p[:, :s_pre.shape[1]].contiguous(), p[:, s_pre.shape[1]:].contiguous()


@functools.cache
def _entry():
    fn = library("latent_softmax").hh_latent_softmax
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def latent_softmax(s_pre, s_tail, scale: float):
    """The merged softmax of (R, P) and (R, t) contiguous f32 scores on a
    CUDA device -> (R, P) and (R, t) bf16 probabilities."""
    if s_pre.device.type != "cuda":
        raise ValueError(f"no latent_softmax kernel for device {s_pre.device}")
    for s in (s_pre, s_tail):
        if s.dtype != torch.float32 or s.dim() != 2 or not s.is_contiguous() or s.device != s_pre.device:
            raise ValueError("latent_softmax takes contiguous (R, n) f32 scores on one device")
    rows, p, t = s_pre.shape[0], s_pre.shape[1], s_tail.shape[1]
    if s_tail.shape[0] != rows:
        raise ValueError(f"the prefix has {rows} rows, the tail {s_tail.shape[0]}")
    out_pre = torch.empty(rows, p, dtype=torch.bfloat16, device=s_pre.device)
    out_tail = torch.empty(rows, t, dtype=torch.bfloat16, device=s_pre.device)
    with torch.cuda.device(s_pre.device):
        rc = _entry()(s_pre.data_ptr(), s_tail.data_ptr(), out_pre.data_ptr(), out_tail.data_ptr(), rows, p, t,
                      float(scale * _LOG2E), torch.cuda.current_stream(s_pre.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"latent_softmax kernel launch failed: cudaError {rc}")
    latent_softmax.launches += 1
    return out_pre, out_tail


latent_softmax.launches = 0


def attend(q, prefix, tail, r: int, scale: float, dv: int):
    """(N, heads, D) query rows over the clip's (clips, P, D) prefix, read
    once for its ``r`` sequences, and each sequence's (N, t, D) tail ->
    (N, heads, dv) in ``q``'s type, the values being each position's first
    ``dv`` columns."""
    n, heads, d = q.shape
    clips, p = prefix.shape[:2]
    t = tail.shape[1]
    s_pre = _bmm_f32(q.reshape(clips, r * heads, d), prefix.transpose(1, 2))  # (clips, r * heads, P)
    s_tail = _bmm_f32(q, tail.transpose(1, 2))  # (N, heads, t)
    if q.is_cuda:
        p_pre, p_tail = latent_softmax(s_pre.view(n * heads, p), s_tail.view(n * heads, t), scale)
    else:
        p_pre, p_tail = latent_softmax_ref(s_pre.view(n * heads, p), s_tail.view(n * heads, t), scale, q.dtype)
    out = torch.bmm(p_pre.view(clips, r * heads, p), prefix[..., :dv]).view(n, heads, dv)
    return out.baddbmm_(p_tail.view(n, heads, t), tail[..., :dv])

