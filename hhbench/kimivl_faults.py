"""Faults planted in the program's Kimi-VL narrator, for the checks that a
broken timed path makes ``correct`` of ``kimivl4f336.b64x10`` come out
false (tests, ``calibrate_kimivl.py``): never used by the benchmark's own
runs. Planted before the model's first batch, so the decode steps' CUDA
graphs are recorded with the fault in them.

- ``weights_from_biased``: the experts' weights taken from the selection
  scores (sigmoid + correction bias), not the sigmoid alone;
- ``shared_skipped``: the shared experts' groups weighted 0, so no token
  gets the shared MLP;
- ``tail_late``: each decode step writes its latents into the tail one
  slot late, so a step attends a slot never written and misses its own;
- ``next_clip_prefix``: each sequence's decode steps read the next clip's
  prefix (the last clip's, the first's).
"""

from __future__ import annotations

import contextlib

FAULTS = ("weights_from_biased", "shared_skipped", "tail_late", "next_clip_prefix")


@contextlib.contextmanager
def planted(name: str | None):
    """The program with the fault ``name`` planted for the duration."""
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"no fault {name!r}; one of {FAULTS}")
    import torch
    import torch.nn.functional as F

    import helping_hand_for_egocentric_videos_torch.models.kimi_lm as kimi_lm

    if name == "weights_from_biased":
        def route(gate, cfg, h):
            select = F.linear(h.float(), gate.weight.float()).sigmoid() + gate.e_score_correction_bias.float()
            idx = torch.topk(select, cfg.num_experts_per_tok, dim=-1).indices
            w = select.gather(1, idx)
            return idx, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor

        patches = [(kimi_lm, "route", route)]
    elif name == "shared_skipped":
        with_shared = kimi_lm.with_shared

        def without_shared(cfg, idx, w):
            ids, wts = with_shared(cfg, idx, w)
            return ids, torch.cat([wts[:, :idx.shape[1]], torch.zeros_like(wts[:, idx.shape[1]:])], dim=1)

        patches = [(kimi_lm, "with_shared", without_shared)]
    elif name == "tail_late":
        write = kimi_lm.LatentCache.write_tail

        def late(self, layer, pos, c, k_pe):
            write(self, layer, min(pos + 1, self.tail.shape[2] - 1), c, k_pe)

        patches = [(kimi_lm.LatentCache, "write_tail", late)]
    else:
        attend = kimi_lm.latent_attend

        def next_clip(q, prefix, tail, r, scale, dv):
            return attend(q, torch.roll(prefix, -1, dims=0), tail, r, scale, dv)

        patches = [(kimi_lm, "latent_attend", next_clip)]
    real = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patches]
    for owner, attr, fake in patches:
        setattr(owner, attr, fake)
    try:
        yield
    finally:
        for owner, attr, old in real:
            setattr(owner, attr, old)
