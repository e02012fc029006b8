"""Where the time of one pretraining step goes, on a CUDA device.

Builds ``chip_smoke.py``'s train inputs (the frozen TimeSformer-L/14 at 4
frames, 224x224, the 13-query decoder with its 22047-class head, seeded
random weights; 16 uint8 clips, 5 captions each, boxes, nouns, a (582,
768) noun dictionary), takes 3 warm-up steps with dropout, then traces
one step three times with ``torch.profiler``. Prints one JSON line per
traced step: the step's wall time, the host time until ``step`` returns,
the device time by kernel (the 20 largest) and by group (the repo's
kernels, matrix products, the rest), the number of kernels launched, and
the device's idle share within the step.

    python3 tools/torch_train_profile.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from torch_forward_profile import _device_us, _group  # noqa: E402


def main():
    name, card = chip_smoke.phase_device()
    from helping_hand_for_egocentric_videos_torch.train import TrainConfig, TrainState, make_train_step

    lcfg, backbone, dcfg, decoder, batch, noun_dict = chip_smoke.build_train_inputs("cuda")
    tcfg = TrainConfig(lr=chip_smoke.TRAIN_LR)
    state = TrainState.create(decoder, tcfg, device="cuda")
    step = make_train_step(dcfg, lcfg, tcfg)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    for _ in range(3):
        state, _ = step(state, backbone, batch, noun_dict, gen)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step(state, backbone, batch, noun_dict, gen)
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        by_kernel = sorted(((e.key, _device_us(e) / 1e3, e.count) for e in kernels), key=lambda r: -r[1])
        groups: dict[str, float] = {}
        for kname, ms, _ in by_kernel:
            groups[_group(kname)] = groups.get(_group(kname), 0.0) + ms
        busy = sum(ms for _, ms, _ in by_kernel)
        print(json.dumps({
            "card": card, "kind": name, "B": chip_smoke.TRAIN_B, "T": chip_smoke.TRAIN_T, "wall_ms": wall_ms,
            "host_ms_until_return": host_ms, "device_busy_ms": busy, "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "kernels_launched": sum(c for _, _, c in by_kernel), "by_group_ms": groups,
            "top_kernels": [{"name": n[:120], "ms": ms, "calls": c} for n, ms, c in by_kernel[:20]],
        }), flush=True)


if __name__ == "__main__":
    main()
