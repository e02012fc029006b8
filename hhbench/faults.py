"""Faults planted in the program, for the checks that a broken timed path
makes ``correct`` come out false (tests, ``calibrate.py``): never used by
the benchmark's own runs."""

from __future__ import annotations

import contextlib

FAULTS = ("altered_answers", "state_unchanged", "half_batch")


@contextlib.contextmanager
def planted(name: str | None):
    """The program with the fault ``name`` planted for the duration:
    ``altered_answers`` every embedding altered where it is made;
    ``state_unchanged`` the optimizer never steps; ``half_batch`` the step
    runs on the first half of each batch's clips and their captions, the
    mean taken over them."""
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"no fault {name!r}; one of {FAULTS}")
    import torch
    import helping_hand_for_egocentric_videos_torch.train as train_pkg
    from helping_hand_for_egocentric_videos_torch.train import EvalModel

    if name == "altered_answers":
        owner, attr = EvalModel, "embed_clips"
        real = EvalModel.embed_clips

        def fake(self, video):
            emb, boxes = real(self, video)
            emb = emb.clone()
            emb[:, 0] += 2 * emb.norm(dim=-1)
            return emb, boxes
    elif name == "state_unchanged":
        owner, attr = torch.optim.AdamW, "step"
        real = torch.optim.AdamW.step

        def fake(self, closure=None):
            return None
    else:
        owner, attr = train_pkg, "make_train_step"
        real = train_pkg.make_train_step

        def fake(*a, **k):
            step = real(*a, **k)

            def half(state, backbone, batch, noun_dict, generator=None, **kw):
                n = batch["video"].shape[0]
                r = batch["tokens"].shape[0] // n
                cut = {key: (v[: n // 2 * r] if key == "tokens" else v[: n // 2]) for key, v in batch.items()}
                return step(state, backbone, cut, noun_dict, generator, **kw)

            return half
    setattr(owner, attr, fake)
    try:
        yield
    finally:
        setattr(owner, attr, real)
