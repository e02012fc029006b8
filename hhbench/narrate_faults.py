"""Faults planted in the program's narrator, for the checks that a broken
timed path makes ``correct`` of ``narrate4f336.b64x10`` come out false
(tests, ``calibrate_narrate.py``): never used by the benchmark's own runs. Planted before the model's first
batch, so the decode steps' CUDA graphs are recorded with the fault in them.

- ``self_cache_late``: each decode step writes its keys and values into
  the self-attention cache one position late, so a step attends a slot
  never written and misses its own token;
- ``cross_skipped_odd_steps``: the gated cross-attention branch is left
  out of every block at odd decode steps, so those tokens never see the
  video.
"""

from __future__ import annotations

import contextlib

FAULTS = ("self_cache_late", "cross_skipped_odd_steps")


@contextlib.contextmanager
def planted(name: str | None):
    """The program with the fault ``name`` planted for the duration."""
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"no fault {name!r}; one of {FAULTS}")
    import torch
    import helping_hand_for_egocentric_videos_torch.models.gpt2 as gpt2

    if name == "self_cache_late":
        write = gpt2.NarrateCache.write

        def late(self, layer, k, v, pos):
            write(self, layer, k, v, min(pos + 1, self.kv.shape[4] - 1))

        patches = [(gpt2.NarrateCache, "write", late)]
    else:
        step, cross = gpt2.decode_step, gpt2.cross_attend
        at = {"pos": 0}

        def step_at(lm, cfg, cache, ids, pos):
            at["pos"] = pos
            return step(lm, cfg, cache, ids, pos)

        def cross_on_even(blk, cfg, h, cache, j, device):
            return torch.zeros_like(h) if at["pos"] % 2 else cross(blk, cfg, h, cache, j, device)

        patches = [(gpt2, "decode_step", step_at), (gpt2, "cross_attend", cross_on_even)]
    real = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patches]
    for owner, attr, fake in patches:
        setattr(owner, attr, fake)
    try:
        yield
    finally:
        for owner, attr, old in real:
            setattr(owner, attr, old)
