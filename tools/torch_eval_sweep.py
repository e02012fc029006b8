#!/usr/bin/env python3
"""Eval batch sweep of the PyTorch port: the 16-frame eval forward at batch
8, 16, 32 and 64, in bf16 or, with ``--int8``, with the visual tower in
int8.

Counterpart of ``tools/eval_sweep.py``. Each batch runs
``tools/torch_bench.py``'s eval stage (``bench_eval``: seeded full-width
TimeSformer-L and the 13-query decoder, time attention N(0, 0.02), one
warm forward and ``--steps`` timed ones ending in
``torch.cuda.synchronize()``) and prints one line: ``eval_sweep_16f_bf16``
or ``eval_sweep_16f_int8`` with the batch, clips/s, ``mfu`` against the
card's dense peak of the type (``utils.flops.PEAKS``), the peak of
``torch.cuda.max_memory_allocated`` and the card with its power limit.
The sweep sets ``torch_bench.EVAL_BATCH``.

    python3 tools/torch_eval_sweep.py [--int8] [--steps 5] [--batches 8 16 32 64]

``--device cpu --backbone timesformer_tiny`` runs it on the CPU at a
miniature width (a rehearsal: its rates are the CPU's and it prints no mfu).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import torch_bench  # noqa: E402


def bench(batch: int, steps: int, quantize: bool, device="cuda", backbone="timesformer_large", card=None) -> dict:
    line = torch_bench.bench_eval(quantize, batch=batch, steps=steps, device=device, backbone=backbone, card=card)
    return {
        "metric": "eval_sweep_16f" + ("_int8" if quantize else "_bf16"),
        "batch": batch,
        "clips_per_sec": line["value"],
        "mfu": line["mfu"],
        "peak_memory_gb": line["peak_memory_gb"],
        "forward_ms": line["forward_ms"],
        "card": line["card"],
        "power_limit_w": line["power_limit_w"],
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--int8", action="store_true")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--batches", type=int, nargs="*", default=[8, 16, 32, 64])
    p.add_argument("--device", default="cuda")
    p.add_argument("--backbone", default="timesformer_large")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_eval_sweep: no CUDA device; pass --device cpu for a CPU rehearsal")
    card = torch_bench.card_info(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    for b in args.batches:
        print(json.dumps(bench(b, args.steps, args.int8, args.device, args.backbone, card)), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
