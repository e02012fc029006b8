"""Sampling of the next token on the device: temperature, nucleus (top-p)
and a seeded draw, with no read back to the host.

The order and rules of HF's logits warpers as LaViLa's narrator calls
them (``generate`` with ``demo_narrator.py``'s settings):

- ``TemperatureLogitsWarper``: the logits over ``temperature``;
- ``TopPLogitsWarper``: sorted ascending, the tokens whose cumulative
  softmax mass is at most ``1 - top_p`` are removed, the most likely token
  always kept;
- the draw from the softmax of what is left. LaViLa calls
  ``torch.multinomial(p, 1)``; here it is the same distribution drawn as
  ``argmax(p / E)`` with ``E`` exponential(1) from ``generator`` (the
  exponential race, which is ATen's own one-sample route), so no check
  of ``p`` waits for the device.
"""

from __future__ import annotations

import torch

__all__ = ["nucleus_mask", "sample_next"]


def nucleus_mask(logits, temperature: float, top_p: float):
    """(N, V) f32 logits -> ((N, V) logits over ``temperature``, (N, V) bool
    True outside the nucleus)."""
    scores = logits / temperature
    sorted_scores, order = torch.sort(scores, dim=-1)
    cum = sorted_scores.softmax(dim=-1).cumsum(dim=-1)
    drop = cum <= 1.0 - top_p
    drop[:, -1] = False
    return scores, drop.scatter(1, order, drop)


def sample_next(logits, temperature: float, top_p: float, generator=None):
    """(N, V) f32 logits -> (N,) int64 ids drawn from the nucleus."""
    scores, drop = nucleus_mask(logits, temperature, top_p)
    probs = scores.masked_fill(drop, float("-inf")).softmax(dim=-1)
    race = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return (probs / race).argmax(dim=-1)
