"""Where the time of one serving forward goes, on a CUDA device.

Builds ``chip_smoke.py``'s serving model (TimeSformer-L/14, 16 frames,
224x224, with the 13-query decoder, seeded random weights), in bf16 and
with ``int8=True``, and traces one 8-clip ``EvalModel.embed_video`` of
each with ``torch.profiler``. Prints one JSON line per model: the forward's
wall time, the device time by kernel (the 15 largest) and by group (the
repo's kernels, matrix products, the rest), and the device's idle share
within the traced forward.

    python3 tools/torch_forward_profile.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402

OURS = ("attention_bf16_kernel", "attention_f32_kernel", "row_int8_kernel", "headgrid_")
GEMM = ("gemm", "Gemm", "nvjet", "cutlass", "sm90_", "cublas", "Kernel2")


def _group(name: str) -> str:
    if any(k in name for k in OURS):
        return "repo_kernels"
    if any(k in name for k in GEMM):
        return "matmul"
    return "other"


def _device_us(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    return float(us if us is not None else evt.self_cuda_time_total)


def profile_forward(model, clips) -> dict:
    model.embed_video(clips)  # warm: kernel builds, allocator pools
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.embed_video(clips)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel = sorted(((e.key, _device_us(e) / 1e3, e.count) for e in kernels), key=lambda r: -r[1])
    groups: dict[str, float] = {}
    for name, ms, _ in by_kernel:
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    busy = sum(ms for _, ms, _ in by_kernel)
    return {
        "int8": model.int8, "clips": len(clips), "wall_ms": wall_ms, "device_busy_ms": busy,
        "idle_share": max(0.0, 1.0 - busy / wall_ms), "by_group_ms": groups,
        "top_kernels": [{"name": n[:120], "ms": ms, "calls": c} for n, ms, c in by_kernel[:15]],
    }


def main():
    name, card = chip_smoke.phase_device()
    from helping_hand_for_egocentric_videos_torch.train import EvalModel

    model = chip_smoke.build_serving_model("cuda")
    model8 = EvalModel(model.backbone, model.lavila_cfg, model.decoder, model.dec_cfg,
                       model.tokenizer, input_res=model.input_res, device="cuda", int8=True)
    t_frames, res = model.lavila_cfg.visual.num_frames, model.input_res
    clips = np.random.default_rng(chip_smoke.SEED).integers(
        0, 256, size=(8, t_frames, res, res, 3), dtype=np.uint8)
    for m in (model, model8, model, model8):  # in turns, twice
        print(json.dumps({"card": card, "kind": name, **profile_forward(m, clips)}), flush=True)


if __name__ == "__main__":
    main()
