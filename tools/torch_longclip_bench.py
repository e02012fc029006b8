"""Long clips through the port's serving forward on a CUDA device.

Counterpart of ``tools/longclip_bench.py``. For each T (default 16, 32,
64, 128): TimeSformer-L/14 + the 13-query decoder, initialised at 4 frames
(the released checkpoints' length) from a seed, both temporal embeddings
inflated to T through ``models.weights.inflate_temporal_embed`` (the eval
CLIs' path), time attention given N(0, 0.02) weights; then
``EvalModel.embed_video`` in bf16 on a batch of uint8 clips at 224x224
(preprocess, tower, decoder and the copies to and from the host included),
one warm call and ``--steps`` timed ones, each ending in a host copy.

Prints the card (``nvidia-smi`` name and power limit), then one JSON line
per T: clips/s, ms/clip, TFLOP/clip (``utils.flops.eval_fwd_flops_per_clip``)
and its share of the card's dense bf16 peak (``mfu_bf16``), the peak of
``torch.cuda.max_memory_allocated``, and which time-attention kernel ran
(K2 ``divided_attention_time`` or K6 ``time_attention_headgrid``) with the
launches of every kernel per forward, and one forward traced with
``torch.profiler`` (``tools/torch_forward_profile.py``: device time by
group and the largest kernels, the idle share); then a summary line.

Before the model sweep, the two time-attention kernels alone: K2 and K6,
each forced, on the same seeded bf16 qkv (N=256, H=16, dh=64) at every
(B, T) of ``--frames`` and at the 16-frame serving bucket (8, 16), timed
with CUDA events, beside the bound of ``chip_smoke._bound_ms`` and the
largest difference between their outputs. One JSON line per shape.

    python3 tools/torch_longclip_bench.py [--batch 2] [--steps 4] [--frames 16 32 64 128]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import torch_forward_profile  # noqa: E402
from helping_hand_for_egocentric_videos_torch.data import ClipTokenizer  # noqa: E402
from helping_hand_for_egocentric_videos_torch.models import (  # noqa: E402
    DecoderConfig,
    Lavila,
    ObjDecoder,
    timesformer_large_config,
)
from helping_hand_for_egocentric_videos_torch.models.weights import inflate_temporal_embed  # noqa: E402
from helping_hand_for_egocentric_videos_torch.ops.counts import read_counts, reset_counts  # noqa: E402
from helping_hand_for_egocentric_videos_torch.train import EvalModel  # noqa: E402
from helping_hand_for_egocentric_videos_torch.utils.flops import eval_fwd_flops_per_clip, peaks_for  # noqa: E402

INIT_T, RES = 4, 224


def build(t: int) -> EvalModel:
    gen = torch.Generator(device="cuda").manual_seed(0)
    backbone = Lavila(timesformer_large_config(num_frames=INIT_T), generator=gen, device="cuda")
    decoder = ObjDecoder(DecoderConfig(num_queries=13, num_frames=INIT_T, pred_traj=False),
                         generator=gen, device="cuda")
    with torch.no_grad():
        for blk in backbone.visual.blocks:
            blk.timeattn.qkv.weight.normal_(0.0, 0.02, generator=gen)
            blk.timeattn.proj.weight.normal_(0.0, 0.02, generator=gen)
        for owner in (backbone.visual, decoder):
            owner.temporal_embed = torch.nn.Parameter(inflate_temporal_embed(owner.temporal_embed, t))
    lcfg = timesformer_large_config(num_frames=t)
    dcfg = DecoderConfig(num_queries=13, num_frames=t, pred_traj=False)
    return EvalModel(backbone, lcfg, decoder, dcfg, ClipTokenizer(), input_res=RES, device="cuda")


def bench_t(t: int, batch: int, steps: int, peak_bf16: float) -> dict:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build(t)
    clips = np.random.default_rng(t).integers(0, 256, size=(batch, t, RES, RES, 3), dtype=np.uint8)
    model.embed_video(clips)  # warm: kernel builds, allocator pools
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        model.embed_video(clips)  # returns host arrays: the device is done
    dt = time.perf_counter() - t0
    per_forward = {k: v // steps for k, v in read_counts().items() if v}
    clips_per_s = batch * steps / dt
    flops = eval_fwd_flops_per_clip(model.lavila_cfg, model.dec_cfg, frames=t)
    row = {
        "frames": t,
        "batch": batch,
        "steps": steps,
        "clips_per_sec": clips_per_s,
        "ms_per_clip": 1e3 / clips_per_s,
        "tflop_per_clip": flops / 1e12,
        "mfu_bf16": clips_per_s * flops / peak_bf16,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "time_kernel": "K6 time_attention_headgrid" if "time_attention_headgrid" in per_forward
        else "K2 divided_attention_time",
        "launches_per_forward": per_forward,
    }
    trace = torch_forward_profile.profile_forward(model, clips)
    row["profile"] = {k: trace[k] for k in ("wall_ms", "device_busy_ms", "idle_share", "by_group_ms")}
    row["profile"]["top_kernels"] = trace["top_kernels"][:6]
    del model
    return row


def time_kernels(shapes, peaks) -> list[dict]:
    """K2 against K6 on the same inputs at each (B, T), bf16."""
    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    n, heads, d = chip_smoke.N, chip_smoke.HEADS, chip_smoke.D
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    rows = []
    for b, t in shapes:
        qkv = torch.randn(b, t, n, 3 * d, generator=gen, device="cuda").to(torch.bfloat16)
        ck, cv, cq = (torch.randn(b, d, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
        runs = {name: (lambda hg=hg: da.divided_patch_attention(qkv, ck, cv, cq, mode="time", heads=heads,
                                                                 head_grid=hg))
                for name, hg in (("K2", False), ("K6", True))}
        (o2, p2), (o6, p6) = runs["K2"](), runs["K6"]()
        cls2, cls6 = (da.merge_cls_partials(*p, cq, ck, cv, heads) for p in (p2, p6))
        diff = max((o2.float() - o6.float()).abs().max().item(), (cls2 - cls6).abs().max().item())
        bound_ms, bound_by = chip_smoke._bound_ms(qkv, "time", peaks)
        row = {"metric": "time_kernel_sweep", "B": b, "T": t, "N": n, "H": heads, "dh": chip_smoke.DH,
               "dtype": "bfloat16", "K2_ms": chip_smoke.cuda_ms(runs["K2"], 20),
               "K6_ms": chip_smoke.cuda_ms(runs["K6"], 20), "bound_ms": bound_ms, "bound_by": bound_by,
               "K2_vs_K6_max_abs_diff": diff, "default_route": "K6" if da.needs_head_grid(t, n, heads) else "K2"}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del qkv, ck, cv, cq, o2, p2, o6, p6, runs
        torch.cuda.empty_cache()
    return rows


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--frames", type=int, nargs="*", default=[16, 32, 64, 128])
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_longclip_bench: no CUDA device; it measures the card only")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    peaks = peaks_for(torch.cuda.get_device_name(0))
    kernel_rows = time_kernels([(args.batch, t) for t in args.frames] + [(8, 16)], peaks)
    rows = []
    for t in args.frames:
        row = {"card": card, **bench_t(t, args.batch, args.steps, peaks["bfloat16"])}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"metric": "torch_longclip_sweep", "card": card, "rows": rows,
                      "time_kernels": kernel_rows}), flush=True)


if __name__ == "__main__":
    main()
