#!/usr/bin/env python3
"""Train-step batch sweep of the PyTorch port, then one traced step.

Counterpart of ``tools/train_sweep.py``. Runs ``tools/torch_bench.py``'s
``bench_train_step`` (the pretraining step on the frozen full-width
TimeSformer-L at 4 frames, 5 captions a clip, AdamW on the decoder) at 8,
16, 32, 64 and 128 clips a step, one ``train_clips_per_sec_per_chip_4f``
line each (with the analytic train FLOPs, ``mfu``, peak memory, the card
and its power limit); then traces one step at 16 clips through
``utils.profiling.trace`` (idle margins around the window) and prints
``utils.profiling.top_ops`` of it as ``train_step_top_ops_bs16``: the
largest self times on the device (kernels) and the host (operators, CUDA
calls), with the busy device time of the trace.

    python3 tools/torch_train_sweep.py [--batches 8 16 32 64 128] [--no-profile]

``--device cpu --backbone timesformer_tiny`` runs it on the CPU at a
miniature width (a rehearsal: the CPU's rates, no mfu).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import torch_bench  # noqa: E402
from helping_hand_for_egocentric_videos_torch.utils.profiling import top_ops, trace  # noqa: E402


def profile_one_step(tmpdir: str, device="cuda", backbone="timesformer_large"):
    """One traced bench train step of 16 clips after a warm one -> (the
    12 largest ``top_ops`` rows, the device's busy ms in the trace)."""
    _, tower, _, state, step, data, noun_dict = torch_bench.train_setup(16, device=device, backbone=backbone)
    gen = torch.Generator(device=device).manual_seed(1)
    state, metrics = step(state, tower, data, noun_dict, gen)
    float(metrics["total_loss"])  # warm-up and sync
    with trace(tmpdir, device):
        state, metrics = step(state, tower, data, noun_dict, gen)
        float(metrics["total_loss"])
    rows = top_ops(tmpdir, k=12)
    busy = sum(ms for ms, where, _ in top_ops(tmpdir, k=10**9) if where == "device")
    return rows, busy


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batches", type=int, nargs="*", default=[8, 16, 32, 64, 128])
    p.add_argument("--steps", type=int, default=torch_bench.STEPS)
    p.add_argument("--profile", action="store_true", default=True)
    p.add_argument("--no-profile", dest="profile", action="store_false")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backbone", default="timesformer_large")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_train_sweep: no CUDA device; pass --device cpu for a CPU rehearsal")
    card = torch_bench.card_info(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    for bs in args.batches:
        line = torch_bench.bench_train_step(batch=bs, steps=args.steps, device=args.device, backbone=args.backbone,
                                            card=card)
        print(json.dumps(line), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()

    if args.profile:
        with tempfile.TemporaryDirectory() as tmp:
            rows, busy = profile_one_step(tmp, args.device, args.backbone)
        print(json.dumps({"metric": "train_step_top_ops_bs16",
                          "ops": [[round(ms, 3), where, name] for ms, where, name in rows],
                          "device_busy_ms": round(busy, 3), **card}), flush=True)


if __name__ == "__main__":
    main()
