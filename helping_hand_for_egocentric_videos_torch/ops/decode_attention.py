"""The narrator's decode attention over its two caches, with its CUDA kernel (K8).

Scaled dot-product attention (scale 1/sqrt(head width), no mask) of the
few query rows a decode step has over a cache, in two modes
(``models/gpt2.py`` calls both at every step):

- self: one query row a (sequence, head), (N, H, dh), over the first
  ``keys`` positions of the self cache's (N, H, S, dh) keys and values;
- cross: a clip's ``r`` query rows a head, (clips * r, H, dh), over the
  clip's (clips, H, M, dh) latent keys and values, which its ``r`` rows
  share.

Both give (rows, H * dh), the layout ``c_proj`` takes.

Three things live here:

- ``self_attention`` and ``cross_attention``: the route, by device alone.
  On a CUDA device the hand-written kernel in ``csrc/decode_attention.cu``
  (``decode_sdpa_self``, ``decode_sdpa_cross``), which raises on what it
  does not take (f32, a head width other than 64, a layout of its rows):
  the card never drops back to a library's attention unseen. On the CPU
  ``F.scaled_dot_product_attention``. Under a profiler each kernel call
  adds one to the counter ``hh.narrate.decode_attn_kernel_calls``; the
  wrappers' ``launches`` attributes count every launch, so that a CUDA
  graph's owner knows how many its recording holds (``launches``).
- the kernel's arithmetic: bf16 inputs widened to f32, scores, the softmax
  (exp2, the scale folded with log2(e)) and the sums in f32, a bf16
  output. The self mode folds ``KEYS_A_STEP`` keys at a time into a
  running max, sum and output row (an online softmax); the cross mode
  takes tiles of ``TILE`` keys, ``WARPS`` interleaved streams of them, each
  its own online softmax, merged in stream order at the end, and carries
  each weight of P as a bf16 pair (hi + lo: 16 significant bits) into
  P V. No atomics, a fixed order: the same inputs give the same bits.
- ``self_attention_ref`` and ``cross_attention_ref``: plain versions of
  that order of work in f32 (the cross one with P unsplit), which the CPU
  tests hold to SDPA and the card's tests hold the kernel to.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from ..utils.profiling import count
from ._build import library

__all__ = [
    "HEAD_DIM", "KEYS_A_STEP", "MAX_CROSS_KEYS", "TILE", "WARPS", "cross_attention", "cross_attention_ref",
    "decode_sdpa_cross", "decode_sdpa_self", "launches", "plan", "self_attention", "self_attention_ref",
]

HEAD_DIM = 64  # the one head width the kernel takes
MAX_CROSS_KEYS = 512  # one block holds a clip's keys and values in shared memory (csrc/decode_attention.cu)
KEYS_A_STEP = 4  # self mode: keys folded into the running softmax at a time
TILE, WARPS = 16, 4  # cross mode: keys a tile, interleaved streams of tiles
_LOG2E = 1.4426950408889634


def self_attention(q, k, v, keys: int):
    """(N, H, dh) query rows over the first ``keys`` positions of the (N, H,
    S, dh) keys and values -> (N, H * dh)."""
    if q.is_cuda:
        out = decode_sdpa_self(q, k, v, keys)
        count("hh.narrate.decode_attn_kernel_calls")
        return out
    out = F.scaled_dot_product_attention(q[:, :, None], k[:, :, :keys], v[:, :, :keys])
    return out.reshape(q.shape[0], -1)


def cross_attention(q, k, v, r: int):
    """(clips * r, H, dh) query rows, a clip's ``r`` rows over its keys and
    values of (clips, H, M, dh) -> (clips * r, H * dh)."""
    if q.is_cuda:
        out = decode_sdpa_cross(q, k, v, r)
        count("hh.narrate.decode_attn_kernel_calls")
        return out
    n, h, dh = q.shape
    out = F.scaled_dot_product_attention(q.view(n // r, r, h, dh).transpose(1, 2), k, v)
    return out.transpose(1, 2).reshape(n, -1)


def self_attention_ref(q, k, v, keys: int):
    """Plain version of the self mode: the same arguments and result, the
    kernel's order of work in f32 (``KEYS_A_STEP`` keys a step; the query
    prescaled by scale * log2(e))."""
    n, h, dh = q.shape
    qf = q.float() * (_LOG2E / math.sqrt(dh))
    kf, vf = k[:, :, :keys].float(), v[:, :, :keys].float()
    m = torch.full((n, h), float("-inf"), device=q.device)
    l = torch.zeros(n, h, device=q.device)
    acc = torch.zeros(n, h, dh, device=q.device)
    for s0 in range(0, keys, KEYS_A_STEP):
        sc = torch.einsum("nhd,nhsd->nhs", qf, kf[:, :, s0:s0 + KEYS_A_STEP])
        mx = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(sc - mx[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("nhs,nhsd->nhd", p, vf[:, :, s0:s0 + KEYS_A_STEP])
        m = mx
    return (acc / l[..., None]).to(q.dtype).reshape(n, -1)


def cross_attention_ref(q, k, v, r: int):
    """Plain version of the cross mode: the same arguments and result, the
    kernel's order of work in f32 (stream ``w`` of ``WARPS`` takes the key
    tiles ``w``, ``w + WARPS``, ...; the streams merge in order), with P in
    f32 where the kernel carries a bf16 pair."""
    n, h, dh = q.shape
    clips, m_keys = k.shape[0], k.shape[2]
    sl2 = _LOG2E / math.sqrt(dh)
    qf = q.float().view(clips, r, h, dh).transpose(1, 2)  # (clips, H, r, dh)
    kf, vf = k.float(), v.float()
    parts = []
    for w in range(WARPS):
        m = torch.full((clips, h, r), float("-inf"), device=q.device)
        l = torch.zeros(clips, h, r, device=q.device)
        o = torch.zeros(clips, h, r, dh, device=q.device)
        for t0 in range(w * TILE, m_keys, WARPS * TILE):
            s = qf @ kf[:, :, t0:t0 + TILE].transpose(-1, -2)
            mx = torch.maximum(m, s.amax(dim=-1))
            cr = torch.exp2(sl2 * (m - mx))
            p = torch.exp2(s * sl2 - (sl2 * mx)[..., None])
            l = l * cr + p.sum(dim=-1)
            o = o * cr[..., None] + p @ vf[:, :, t0:t0 + TILE]
            m = mx
        parts.append((m, l, o))
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    lt = torch.zeros_like(top)
    acc = torch.zeros(clips, h, r, dh, device=q.device)
    for m, l, o in parts:
        f = torch.exp2(sl2 * (m - top))
        lt = lt + f * l
        acc = acc + f[..., None] * o
    return (acc / lt[..., None]).to(q.dtype).transpose(1, 2).reshape(n, -1)


@functools.cache
def _entries():
    """The kernels' C entry points with their argument types set (built
    and loaded at the first call)."""
    lib = library("decode_attention")
    ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.hh_decode_sdpa_self.argtypes = [p] * 4 + [ll, i, i, ll, ll, ll, ll, ctypes.c_float, p]
    lib.hh_decode_sdpa_cross.argtypes = [p] * 4 + [i, i, i, i, ll, ll, ll, ll, ctypes.c_float, p]
    lib.hh_decode_sdpa_plan.argtypes = [i, i, ctypes.POINTER(ll)]
    for fn in (lib.hh_decode_sdpa_self, lib.hh_decode_sdpa_cross, lib.hh_decode_sdpa_plan):
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, q, k, v):
    """Raise unless the kernel takes these: CUDA tensors on one device,
    bf16, head width 64, each row contiguous and 16-byte aligned."""
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} takes tensors on one CUDA device, got {t.device} beside {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} takes bfloat16, got {t.dtype}")
        if t.shape[-1] != HEAD_DIM or t.stride(-1) != 1:
            raise ValueError(f"{name} takes rows of {HEAD_DIM} contiguous values, got shape {tuple(t.shape)} "
                             f"strides {t.stride()}")
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:-1]):
            raise ValueError(f"{name} takes 16-byte aligned rows, got strides {t.stride()}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(f"{name} has no backward")


def _launch(name: str, fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def decode_sdpa_self(q, k, v, keys: int):
    """The self mode's kernel: (N, H, 64) bf16 query rows (any strides of
    whole rows: the ``c_attn`` output's view) over the first ``keys``
    positions of (N, H, S, 64) bf16 keys and values whose positions are
    contiguous rows -> (N, H * 64) bf16."""
    _check("decode_sdpa_self", q, k, v)
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape or k.stride() != v.stride() or k.shape[:2] != q.shape[:2]:
        raise ValueError(f"decode_sdpa_self takes q (N, H, 64) and k, v (N, H, S, 64) of one layout, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)} {k.stride()}, {tuple(v.shape)} {v.stride()}")
    if k.stride(2) != HEAD_DIM:
        raise ValueError(f"decode_sdpa_self takes contiguous positions, got strides {k.stride()}")
    if not 1 <= keys <= k.shape[2]:
        raise ValueError(f"decode_sdpa_self takes 1..{k.shape[2]} keys, got {keys}")
    n, h, dh = q.shape
    out = torch.empty(n, h * dh, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _launch("decode_sdpa_self", _entries().hh_decode_sdpa_self, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), n * h, h, keys, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream)
    decode_sdpa_self.launches += 1
    return out


decode_sdpa_self.launches = 0


def decode_sdpa_cross(q, k, v, r: int):
    """The cross mode's kernel: (clips * r, H, 64) bf16 query rows over the
    clip's (clips, H, M, 64) bf16 keys and values, M from 1 to
    ``MAX_CROSS_KEYS``, positions contiguous rows -> (clips * r, H * 64)
    bf16."""
    _check("decode_sdpa_cross", q, k, v)
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape or k.stride() != v.stride() or k.shape[1] != q.shape[1]:
        raise ValueError(f"decode_sdpa_cross takes q (clips * r, H, 64) and k, v (clips, H, M, 64) of one layout, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)} {k.stride()}, {tuple(v.shape)} {v.stride()}")
    clips, h, m_keys, dh = k.shape
    if r < 1 or q.shape[0] != clips * r:
        raise ValueError(f"decode_sdpa_cross takes {clips} clips x r rows, got {q.shape[0]} rows at r = {r}")
    if k.stride(2) != HEAD_DIM or not 1 <= m_keys <= MAX_CROSS_KEYS:
        raise ValueError(f"decode_sdpa_cross takes 1..{MAX_CROSS_KEYS} contiguous keys, got shape "
                         f"{tuple(k.shape)} strides {k.stride()}")
    out = torch.empty(q.shape[0], h * dh, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _launch("decode_sdpa_cross", _entries().hh_decode_sdpa_cross, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), clips, h, r, m_keys, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream)
    decode_sdpa_cross.launches += 1
    return out


decode_sdpa_cross.launches = 0


def launches() -> int:
    """The kernel's launches so far, both modes."""
    return decode_sdpa_self.launches + decode_sdpa_cross.launches


def plan(mode: str, m_keys: int = 256, device=None) -> dict:
    """The kernel's cut on the current CUDA device: threads a block, blocks
    an SM, SMs and dynamic shared memory a block (cross: at ``m_keys``)."""
    out = (ctypes.c_longlong * 4)()
    with torch.cuda.device(device):
        rc = _entries().hh_decode_sdpa_plan({"self": 0, "cross": 1}[mode], m_keys, out)
    if rc != 0:
        raise RuntimeError(f"hh_decode_sdpa_plan failed: cudaError {rc}")
    return dict(zip(("threads", "blocks_an_sm", "sms", "smem_bytes"), out))
