"""Sampling of the next token on the device: temperature, nucleus (top-p)
and a seeded draw, with no read back to the host.

The order and rules of HF's logits warpers as LaViLa's narrator calls
them (``generate`` with ``demo_narrator.py``'s settings):

- ``TemperatureLogitsWarper``: the scores are the logits over
  ``temperature``;
- ``TopPLogitsWarper`` in its descending form (as
  ``hhbench/reference/narrator.py::nucleus`` writes it): a token is kept
  where the softmax mass of the tokens strictly more likely than it is
  below ``top_p``. The rule is one on values: the edge is the lowest kept
  score, and every score at or above it is kept, so tokens tied exactly
  at the edge are all kept and the most likely token always is (also at
  ``top_p`` 0). A ``-inf`` logit has no mass and is never kept; a row
  without a finite logit draws 0;
- the draw from the softmax of what is left. LaViLa calls
  ``torch.multinomial(p, 1)``; here it is the exponential race: the
  argmax over the kept tokens of ``score - log(E)``, ``E`` exponential(1),
  ties to the lowest index. That is ``argmax(p / E)`` with the log taken
  and draws the same distribution; the softmax's normalisation does not
  move an argmax, so none is computed.

Two routes compute that function on f32 logits, in f32, but for the
masses: each weight ``exp(s - max)`` is counted in integer units of 2^-36,
so every sum is exact, in any order:

- a CUDA tensor: one launch of the hand-written kernel in
  ``csrc/nucleus_sample.cu`` (``nucleus_sample``): the row staged in
  shared memory, the edge found by a mass-weighted radix select, the race
  over the kept tokens. Rows up to ``MAX_VOCAB`` tokens; nothing falls
  back;
- a CPU tensor: the plain version (``nucleus_threshold_ref``,
  ``sample_next_ref``), the same arithmetic by a sort.

The random bits: each call draws one 64-bit seed from ``generator`` on the
logits' device (``torch.randint``, no read back on the card), and the
token in column ``c`` of row ``r`` takes word ``c % 4`` of Philox4x32-10
of the counter (c // 4, r, 0, 0) under that seed, as ``u = (2 (x >> 9) + 1) /
2^24`` in (0, 1) and ``E = -log(u)``. Both routes compute the same bits
(``philox_uniform``), so they find the same edge and draw the same ids
from the same seed but where an exp or a log differs in its last bit at
the edge or on a near tie. The same generator gives the same ids; these are not
the ids ``torch.multinomial`` or an ``exponential_`` draw would give from
that generator, which take other bits (and ``torch.multinomial`` another
method), though the distribution is the same.

``nucleus_mask`` is the sort route the port first had (the whole nucleus
as a mask); the tests hold it and the plain threshold against the
reference.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.profiling import count
from ._build import library

__all__ = [
    "MAX_VOCAB",
    "nucleus_mask",
    "nucleus_threshold_ref",
    "philox_uniform",
    "sample_next_ref",
    "nucleus_sample",
    "sample_next",
]

MAX_VOCAB = 53248  # the kernel holds a row in one block's shared memory (csrc/nucleus_sample.cu)

_M0, _M1, _W0, _W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def nucleus_mask(logits, temperature: float, top_p: float):
    """(N, V) f32 logits -> ((N, V) logits over ``temperature``, (N, V) bool
    True outside the nucleus)."""
    scores = logits / temperature
    sorted_scores, order = torch.sort(scores, dim=-1)
    cum = sorted_scores.softmax(dim=-1).cumsum(dim=-1)
    drop = cum <= 1.0 - top_p
    drop[:, -1] = False
    return scores, drop.scatter(1, order, drop)


def _weights_fixed(scores, top):
    """The kernel's weights: ``exp(s - top)`` in f32, counted in units of
    2^-36 (int64; exact from 2^-13 up, rounded to the nearest unit below);
    0 in a row without a finite score."""
    w = torch.exp(scores - top).nan_to_num(nan=0.0)
    return torch.round(w.double() * 2.0 ** 36).long()


def nucleus_threshold_ref(logits, temperature: float, top_p: float):
    """Plain version of the kernel's edge: (N, V) f32 logits -> (scores (N,
    V), edge (N,)): the lowest score of positive weight whose mass above is
    below ``top_p`` (as f32) times the row's mass, in float64 over the
    exact integer sums of ``_weights_fixed``, or the top score where none
    is; a row keeps every score at or above its edge (+inf for a row
    without a finite logit, which keeps none)."""
    scores = logits / temperature
    top = scores.amax(dim=-1, keepdim=True)
    w = _weights_fixed(scores, top)
    target = float(torch.tensor(top_p, dtype=torch.float32)) * w.sum(dim=-1, keepdim=True).double()
    sv, order = torch.sort(scores, dim=-1, descending=True)
    ws = w.gather(1, order)
    above = torch.cat([torch.zeros_like(ws[:, :1]), ws.cumsum(dim=-1)[:, :-1]], dim=-1)
    # a tie group's mass above is its first member's
    pos = torch.arange(sv.shape[1], device=sv.device).expand_as(sv)
    first = torch.where(torch.cat([torch.ones_like(sv[:, :1], dtype=torch.bool), sv[:, 1:] != sv[:, :-1]], 1),
                        pos, 0).cummax(dim=-1).values
    above = above.gather(1, first)
    cand = (ws > 0) & ((above.double() < target) | (sv == top))
    edge = torch.where(cand, sv, float("inf")).amin(dim=-1)
    return scores, edge


def _mulhilo(a: int, b):
    """(hi, lo) 32-bit words of the constant ``a`` times the 32-bit words
    ``b`` (int64), without leaving int64."""
    p_lo = a * (b & 0xFFFF)
    t = a * (b >> 16) + (p_lo >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def _philox(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) of the counters (c0, c1, c2, c3),
    int64 tensors of 32-bit words, under the key (k0, k1) -> 4 words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
    return c0, c1, c2, c3


def philox_uniform(seed: int, rows: int, cols: int, device="cpu"):
    """(rows, cols) f32 uniforms in (0, 1) of the kernel's stream: column c
    of row r from word c % 4 of Philox4x32-10 of (c // 4, r, 0, 0) under the
    64-bit ``seed``."""
    seed &= (1 << 64) - 1
    quads = (cols + 3) // 4
    c0 = torch.arange(quads, dtype=torch.int64, device=device).expand(rows, quads)
    c1 = torch.arange(rows, dtype=torch.int64, device=device)[:, None].expand(rows, quads)
    zero = torch.zeros_like(c0)
    x = torch.stack(_philox(c0, c1, zero, zero, seed & _U32, seed >> 32), dim=-1).reshape(rows, 4 * quads)[:, :cols]
    return (((x >> 9) << 1) | 1).float() * 2.0 ** -24


def sample_next_ref(logits, temperature: float, top_p: float, seed: int):
    """Plain version of ``nucleus_sample``: (N, V) f32 logits -> (N,) int64
    ids, the edge (``nucleus_threshold_ref``), then the race on the
    Philox stream of ``seed``."""
    scores, edge = nucleus_threshold_ref(logits, temperature, top_p)
    e = -torch.log(philox_uniform(seed, *scores.shape, device=scores.device))
    race = torch.where(scores >= edge[:, None], scores - torch.log(e), float("-inf"))
    return race.argmax(dim=-1)


@functools.cache
def _entry():
    """The kernel's C entry point with its argument types set (built and
    loaded at the first call)."""
    fn = library("nucleus_sample").hh_nucleus_sample
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def nucleus_sample(logits, temperature: float, top_p: float, seed, threshold=None):
    """The kernel: (N, V) f32 contiguous logits on a CUDA device, ``seed`` a
    one-element int64 tensor there -> (N,) int64 ids. ``threshold``, an (N,)
    f32 tensor there or None, receives each row's edge (tests)."""
    if logits.device.type != "cuda":
        raise ValueError(f"no nucleus_sample kernel for device {logits.device}")
    if logits.dtype != torch.float32:
        raise TypeError(f"nucleus_sample takes float32 logits, got {logits.dtype}")
    if logits.dim() != 2 or not logits.is_contiguous():
        raise ValueError(f"nucleus_sample takes contiguous (N, V) logits, got shape {tuple(logits.shape)}")
    n, v = logits.shape
    if not 1 <= v <= MAX_VOCAB:
        raise ValueError(f"nucleus_sample takes rows of 1..{MAX_VOCAB} tokens (one block's shared memory), got {v}")
    if not temperature > 0:
        raise ValueError(f"nucleus_sample takes a positive temperature, got {temperature}")
    if seed.device != logits.device or seed.dtype != torch.int64 or seed.numel() != 1:
        raise ValueError("nucleus_sample takes a one-element int64 seed on the logits' device")
    if threshold is not None and (threshold.device != logits.device or threshold.dtype != torch.float32
                                  or threshold.shape != (n,)):
        raise ValueError(f"threshold must be a ({n},) float32 tensor on {logits.device}")
    out = torch.empty(n, dtype=torch.int64, device=logits.device)
    with torch.cuda.device(logits.device):
        rc = _entry()(logits.data_ptr(), out.data_ptr(), None if threshold is None else threshold.data_ptr(),
                      seed.data_ptr(), n, v, float(temperature), float(top_p),
                      torch.cuda.current_stream(logits.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nucleus_sample kernel launch failed: cudaError {rc}")
    nucleus_sample.launches += 1
    return out


nucleus_sample.launches = 0


def sample_next(logits, temperature: float, top_p: float, generator=None):
    """(N, V) f32 logits -> (N,) int64 ids drawn from the nucleus: the
    kernel on a CUDA tensor, the plain version on a CPU one."""
    seed = torch.randint(-(2 ** 63), 2 ** 63 - 1, (1,), generator=generator, device=logits.device)
    if logits.device.type == "cpu":
        return sample_next_ref(logits, temperature, top_p, int(seed))
    ids = nucleus_sample(logits, temperature, top_p, seed)
    count("hh.narrate.sample_kernel_rows", logits.shape[0])
    return ids
