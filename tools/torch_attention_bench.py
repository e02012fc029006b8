"""Time the divided-attention kernels (K1, K2, K3) of the port on a CUDA device.

At the 16-frame serving shape (B=8, T=16) and the long-clip shape of space
attention (B=2, T=128), N=256, H=16, dh=64, bf16 inputs seeded N(0, 1):
each kernel through its wrapper, its plain version and one
``F.scaled_dot_product_attention`` call over [CLS | group keys] (the
yardstick; the port never calls it), with CUDA events over ``--iters``
launches, ``--repeat`` times in turn; beside ``chip_smoke._bound_ms`` and
the kernel's cut of the group (``chip_smoke._plan``). One JSON line per
(kernel, shape), after the card's ``nvidia-smi`` name and power limit.

    python3 tools/torch_attention_bench.py [--iters 50] [--repeat 3]

To compare two versions on one card, run it from the root of each checkout
in the same call, in turns (old, new, new, old).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da  # noqa: E402

CASES = (  # (kernel, mode, quant_out, B, T)
    ("K1", "space", False, 8, 16), ("K1", "space", False, 2, 128), ("K2", "time", False, 8, 16),
    ("K3", "space", True, 8, 16), ("K3", "time", True, 8, 16),
)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--repeat", type=int, default=3)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_attention_bench: no CUDA device; it measures the card only")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    peaks = chip_smoke.PEAKS["pcie" if "pcie" in torch.cuda.get_device_name(0).lower() else "sxm"]
    n, heads, d = chip_smoke.N, chip_smoke.HEADS, chip_smoke.D
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    for kernel, mode, quant_out, b, t in CASES:
        qkv = torch.randn(b, t, n, 3 * d, generator=gen, device="cuda").to(torch.bfloat16)
        ck, cv, cq = (torch.randn(b, d, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
        q, k, v = chip_smoke._sdpa_inputs(qkv, ck, cv, mode)
        runs = {
            "ms": lambda: da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=heads, quant_out=quant_out),
            "plain_ms": lambda: da.divided_patch_attention_ref(qkv, ck, cv, cq, mode=mode, heads=heads,
                                                               quant_out=quant_out),
            "library_ms": lambda: F.scaled_dot_product_attention(q, k, v),
        }
        times = {key: [chip_smoke.cuda_ms(fn, args.iters if key != "plain_ms" else 5) for _ in range(args.repeat)]
                 for key, fn in runs.items()}
        bound_ms, bound_by = chip_smoke._bound_ms(qkv, mode, peaks, quant_out=quant_out)
        print(json.dumps({"metric": "attention_timing", "kernel": kernel, "mode": mode, "quant_out": quant_out,
                          "B": b, "T": t, "N": n, "H": heads, "dh": chip_smoke.DH, "card": card,
                          **{key: min(v) for key, v in times.items()}, "all": times, "bound_ms": bound_ms,
                          "bound_by": bound_by, "plan": chip_smoke._plan(n if mode == "space" else t)}),
              flush=True)
        del qkv, ck, cv, cq, q, k, v, runs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
