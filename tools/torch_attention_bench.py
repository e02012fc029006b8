"""Time the port's attention and row kernels alone on a CUDA device.

Attention (N=256, H=16, dh=64, bf16 inputs seeded N(0, 1)): K1 at the
16-frame serving shape (B=8, T=16) and the long-clip shape (B=2, T=128), K2
and K3 at (8, 16), K3 at the int8 loop's (32, 4) and in space mode at
(2, 128), K2 forced at (2, 128), and K6 (the head-grid time kernel,
forced) at (1, 128) and (2, 128). Each kernel through its wrapper, its plain version and one
``F.scaled_dot_product_attention`` call over [CLS | group keys] (the
yardstick; the port never calls it), with CUDA events over ``--iters``
launches, ``--repeat`` times in turn, and the device time of every kernel
a call launches in a ``torch.profiler`` trace (``device_ms``, with the
launches a call by name: K3 is two, its attention and row passes); beside
``chip_smoke._bound_ms`` and the kernel's cut (``chip_smoke._plan``,
``chip_smoke._headgrid_plan``).

Rows (32768 rows of the serving shape, bf16, seeded N(0, 1)): K4
(LayerNorm -> int8, D=1024, gamma 1 + 0.2 N(0, 1), beta 0.1 N(0, 1)) and K5
(QuickGELU -> int8, D=4096), each beside its plain version, the bytes it
moves, its bound (``chip_smoke._rows_bound_ms``) and the share of it
reached, from the kernel's device time in a ``torch.profiler`` trace
(``chip_smoke.device_ms``: back-to-back calls timed with events measure the
wrapper's host time where it exceeds the kernel's); K4 with its route
(``chip_smoke._ln_plan``).

One JSON line per (kernel, shape), after the card's ``nvidia-smi`` name and
power limit.

    python3 tools/torch_attention_bench.py [--iters 50] [--repeat 3] [--kernels K6 K4]

To compare two versions on one card, copy this script and ``chip_smoke.py``
into the other checkout and run it from the root of each checkout in the
same call, in turns (old, new, new, old): it times each checkout's own
wrappers.
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
from torch import nn  # noqa: E402

import chip_smoke  # noqa: E402
from helping_hand_for_egocentric_videos_torch.ops import act_quant as aq  # noqa: E402
from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da  # noqa: E402
from helping_hand_for_egocentric_videos_torch.ops._build import library  # noqa: E402
from helping_hand_for_egocentric_videos_torch.utils.flops import peaks_for  # noqa: E402

CASES = (  # (kernel, mode, quant_out, head_grid, B, T)
    ("K1", "space", False, None, 8, 16), ("K1", "space", False, None, 2, 128),
    ("K2", "time", False, False, 8, 16), ("K3", "space", True, None, 8, 16), ("K3", "time", True, None, 8, 16),
    ("K3", "space", True, None, 32, 4), ("K3", "time", True, None, 32, 4), ("K3", "space", True, None, 2, 128),
    ("K2", "time", False, False, 2, 128), ("K6", "time", False, True, 1, 128), ("K6", "time", False, True, 2, 128),
)
ROW_CASES = (("K4", 1024, 14), ("K5", 4096, 12))  # (kernel, D, f32 ops a value)


def _plan_of(lib: str, symbol: str, plan_fn, *args):
    """A kernel's cut, or None where the checkout's library has no query
    for it (an older version of the kernel, in an A/B across checkouts)."""
    return plan_fn(*args) if hasattr(library(lib), symbol) else None


def _window(fn, iters: int) -> dict:
    """Every kernel one call of ``fn`` launches, from a ``torch.profiler``
    trace of ``iters`` calls (``chip_smoke._kernel_events``): the device ms
    a call (all of them) and the launches a call by kernel name."""
    kernels = [e for e in chip_smoke._kernel_events(fn, iters) if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(float(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total) for e in kernels)
    return {"device_ms": us / iters / 1e3, "launches_a_call": {e.key[:60]: e.count / iters for e in kernels}}


def _times(runs: dict, iters: int, repeat: int) -> dict:
    return {key: [chip_smoke.cuda_ms(fn, iters if key != "plain_ms" else 5) for _ in range(repeat)]
            for key, fn in runs.items()}


def bench_attention(args, card, peaks):
    n, heads, d = chip_smoke.N, chip_smoke.HEADS, chip_smoke.D
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    for kernel, mode, quant_out, head_grid, b, t in CASES:
        if args.kernels and kernel not in args.kernels:
            continue
        qkv = torch.randn(b, t, n, 3 * d, generator=gen, device="cuda").to(torch.bfloat16)
        ck, cv, cq = (torch.randn(b, d, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
        q, k, v = chip_smoke._sdpa_inputs(qkv, ck, cv, mode)
        runs = {
            "ms": lambda: da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=heads, quant_out=quant_out,
                                                     head_grid=head_grid),
            "plain_ms": lambda: da.divided_patch_attention_ref(qkv, ck, cv, cq, mode=mode, heads=heads,
                                                               quant_out=quant_out),
            "library_ms": lambda: F.scaled_dot_product_attention(q, k, v),
        }
        times = _times(runs, args.iters, args.repeat)
        windows = [_window(runs["ms"], args.iters) for _ in range(args.repeat)]
        extra = {"device_ms": min(w["device_ms"] for w in windows), "device_all": [w["device_ms"] for w in windows],
                 "launches_a_call": windows[0]["launches_a_call"]}
        bound_ms, bound_by = chip_smoke._bound_ms(qkv, mode, peaks, quant_out=quant_out)
        plan = (_plan_of("divided_attention_long", "hh_time_attention_headgrid_plan", chip_smoke._headgrid_plan, t,
                         b * n * heads) if head_grid else chip_smoke._plan(n if mode == "space" else t))
        print(json.dumps({"metric": "attention_timing", "kernel": kernel, "mode": mode, "quant_out": quant_out,
                          "B": b, "T": t, "N": n, "H": heads, "dh": chip_smoke.DH, "card": card,
                          **{key: min(v) for key, v in times.items()}, "all": times, "bound_ms": bound_ms,
                          "bound_by": bound_by, "bound_share": bound_ms / extra["device_ms"], "plan": plan, **extra}),
              flush=True)
        del qkv, ck, cv, cq, q, k, v, runs
        torch.cuda.empty_cache()


def bench_rows(args, card, peaks):
    rows = 8 * 16 * chip_smoke.N
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 2)
    for kernel, d, ops in ROW_CASES:
        if args.kernels and kernel not in args.kernels:
            continue
        x = torch.randn(rows, d, generator=gen, device="cuda").to(torch.bfloat16)
        if kernel == "K4":
            ln = nn.LayerNorm(d, device="cuda")
            with torch.no_grad():
                ln.weight.copy_(1.0 + 0.2 * torch.randn(d, generator=gen, device="cuda"))
                ln.bias.copy_(0.1 * torch.randn(d, generator=gen, device="cuda"))
            runs = {"ms": lambda: aq.layer_norm_int8(ln, x, 1e-6), "plain_ms": lambda: aq.layer_norm_int8_ref(ln, x, 1e-6)}
            extra = {"plan": _plan_of("act_quant", "hh_layer_norm_int8_plan", chip_smoke._ln_plan, x)}
            # the warp-row kernel, or the block-row one of an older checkout
            name = "ln_int8_warp_kernel" if extra["plan"] else "row_int8_kernel"
        else:
            runs = {"ms": lambda: aq.quick_gelu_int8(x), "plain_ms": lambda: aq.quick_gelu_int8_ref(x)}
            extra, name = {}, "row_int8_kernel"
        times = _times(runs, args.iters, args.repeat)
        dev = [chip_smoke.device_ms(runs["ms"], args.iters, name) for _ in range(args.repeat)]
        nbytes = chip_smoke._rows_bytes(rows, d, x.element_size())
        bound_ms, bound_by = chip_smoke._rows_bound_ms(rows, d, x.element_size(), ops, peaks)
        ms = min(dev)
        print(json.dumps({"metric": "rows_timing", "kernel": kernel, "rows": rows, "D": d, "dtype": "bfloat16",
                          "card": card, **{key: min(v) for key, v in times.items()}, "all": times,
                          "device_ms": ms, "device_all": dev, "bytes_moved": nbytes,
                          "achieved_tb_per_s": nbytes / (ms * 1e-3) / 1e12, "bound_ms": bound_ms,
                          "bound_by": bound_by, "bound_share": bound_ms / ms, **extra}),
              flush=True)
        del x, runs
        torch.cuda.empty_cache()


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--repeat", type=int, default=3)
    p.add_argument("--kernels", nargs="*", default=None, help="time only these (K1 ... K6)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_attention_bench: no CUDA device; it measures the card only")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    peaks = peaks_for(torch.cuda.get_device_name(0))
    bench_attention(args, card, peaks)
    bench_rows(args, card, peaks)


if __name__ == "__main__":
    main()
