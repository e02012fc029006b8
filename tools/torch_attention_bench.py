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
its bound (``ops.bounds.attention_bound_ms``) and the kernel's cut
(``ops.divided_attention.plan``, ``headgrid_plan``).

Rows (32768 rows of the serving shape, bf16, seeded N(0, 1)): K4
(LayerNorm -> int8, D=1024, gamma 1 + 0.2 N(0, 1), beta 0.1 N(0, 1)) and K5
(QuickGELU -> int8, D=4096), each beside its plain version, the bytes it
moves, its bound (``ops.bounds.rows_bound_ms``) and the share of it
reached, from the kernel's device time in a ``torch.profiler`` trace
(``utils.profiling.device_ms``: back-to-back calls timed with events
measure the wrapper's host time where it exceeds the kernel's); K4 with its
route (``ops.act_quant.layer_norm_plan``).

Decode attention (K8, the narrator's shapes, bf16 seeded N(0, 1)): the self
mode at 640 sequences x 25 heads over 1, 33 and 77 of 77 cached positions
(the query a view of ``c_attn``'s packed rows, as ``models/gpt2.py`` has
it) and the cross mode at 64 clips x 10 rows over 256 latents, each
through ``ops.decode_attention``'s route, its plain version and the
``F.scaled_dot_product_attention`` call the decode step made before K8
(``library_ms``, with its device time ``library_device_ms``), beside its
bound (``ops.bounds.decode_attention_bound_ms``) and its cut
(``decode_attention.plan``). The 1- and 33-key caches fit in the 50 MB L2,
so repeated calls read them warm; the 77-key one (315 MB) and the cross
cache (105 MB) do not.

One JSON line per (kernel, shape), after the card's ``nvidia-smi`` name and
power limit.

    python3 tools/torch_attention_bench.py [--iters 50] [--repeat 3] [--kernels K6 K4]

To compare two versions on one card, run it from the root of each
checkout in the same call, in turns (old, new, new, old): it times each
checkout's own wrappers. The shapes and the SDPA yardstick's inputs are
``chip_smoke.py``'s.
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
from helping_hand_for_egocentric_videos_torch.ops import decode_attention as dec  # noqa: E402
from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da  # noqa: E402
from helping_hand_for_egocentric_videos_torch.ops._build import library  # noqa: E402
from helping_hand_for_egocentric_videos_torch.ops.bounds import (  # noqa: E402
    attention_bound_ms,
    decode_attention_bound_ms,
    rows_bound_ms,
    rows_bytes,
)
from helping_hand_for_egocentric_videos_torch.utils.flops import peaks_for  # noqa: E402
from helping_hand_for_egocentric_videos_torch.utils.profiling import cuda_ms, device_ms, kernel_events  # noqa: E402

CASES = (  # (kernel, mode, quant_out, head_grid, B, T)
    ("K1", "space", False, None, 8, 16), ("K1", "space", False, None, 2, 128),
    ("K2", "time", False, False, 8, 16), ("K3", "space", True, None, 8, 16), ("K3", "time", True, None, 8, 16),
    ("K3", "space", True, None, 32, 4), ("K3", "time", True, None, 32, 4), ("K3", "space", True, None, 2, 128),
    ("K2", "time", False, False, 2, 128), ("K6", "time", False, True, 1, 128), ("K6", "time", False, True, 2, 128),
)
ROW_CASES = (("K4", 1024, 14), ("K5", 4096, 12))  # (kernel, D, f32 ops a value)
# (mode, sequences or clips, keys): the narrator's 640 sequences x 25 heads, 64 clips x 10 rows
DECODE_CASES = (("self", 640, 1), ("self", 640, 33), ("self", 640, 77), ("cross", 64, 256))
DECODE_H, DECODE_DH, DECODE_S, DECODE_R = 25, 64, 77, 10


def _plan_of(lib: str, symbol: str, plan_fn, *args):
    """A kernel's cut, or None where the checkout's library has no query
    for it (an older version of the kernel, in an A/B across checkouts)."""
    return plan_fn(*args) if hasattr(library(lib), symbol) else None


def _window(fn, iters: int) -> dict:
    """Every kernel one call of ``fn`` launches, from a ``torch.profiler``
    trace of ``iters`` calls (``kernel_events``): the device ms a call (all
    of them) and the launches a call by kernel name."""
    kernels = [e for e in kernel_events(fn, iters) if e.device_type == torch.autograd.DeviceType.CUDA]
    us = sum(float(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total) for e in kernels)
    return {"device_ms": us / iters / 1e3, "launches_a_call": {e.key[:60]: e.count / iters for e in kernels}}


def _times(runs: dict, iters: int, repeat: int) -> dict:
    return {key: [cuda_ms(fn, iters if key != "plain_ms" else 5) for _ in range(repeat)]
            for key, fn in runs.items()}


def bench_attention(args, card, peaks):
    n, heads, d, dh = chip_smoke.N, chip_smoke.HEADS, chip_smoke.D, chip_smoke.DH
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
        bound_ms, bound_by = attention_bound_ms(b, t, n, heads, dh, "bfloat16", mode, peaks, quant_out=quant_out)
        plan = (_plan_of("divided_attention_long", "hh_time_attention_headgrid_plan", da.headgrid_plan, t,
                         b * n * heads, dh) if head_grid else da.plan(n if mode == "space" else t, heads, dh))
        print(json.dumps({"metric": "attention_timing", "kernel": kernel, "mode": mode, "quant_out": quant_out,
                          "B": b, "T": t, "N": n, "H": heads, "dh": dh, "card": card,
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
            extra = {"plan": _plan_of("act_quant", "hh_layer_norm_int8_plan", aq.layer_norm_plan, x)}
            # the warp-row kernel, or the block-row one of an older checkout
            name = "ln_int8_warp_kernel" if extra["plan"] else "row_int8_kernel"
        else:
            runs = {"ms": lambda: aq.quick_gelu_int8(x), "plain_ms": lambda: aq.quick_gelu_int8_ref(x)}
            extra, name = {}, "row_int8_kernel"
        times = _times(runs, args.iters, args.repeat)
        dev = [device_ms(runs["ms"], args.iters, name) for _ in range(args.repeat)]
        nbytes = rows_bytes(rows, d, x.element_size())
        bound_ms, bound_by = rows_bound_ms(rows, d, x.element_size(), ops, peaks)
        ms = min(dev)
        print(json.dumps({"metric": "rows_timing", "kernel": kernel, "rows": rows, "D": d, "dtype": "bfloat16",
                          "card": card, **{key: min(v) for key, v in times.items()}, "all": times,
                          "device_ms": ms, "device_all": dev, "bytes_moved": nbytes,
                          "achieved_tb_per_s": nbytes / (ms * 1e-3) / 1e12, "bound_ms": bound_ms,
                          "bound_by": bound_by, "bound_share": bound_ms / ms, **extra}),
              flush=True)
        del x, runs
        torch.cuda.empty_cache()


def bench_decode(args, card, peaks):
    if args.kernels and "K8" not in args.kernels:
        return
    h, dh = DECODE_H, DECODE_DH
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 3)
    for mode, b, keys in DECODE_CASES:
        if mode == "self":
            n = b
            q = torch.randn(n, 3 * h * dh, generator=gen, device="cuda").to(torch.bfloat16).view(n, 3, h, dh)[:, 0]
            kv = torch.randn(2, n, h, DECODE_S, dh, generator=gen, device="cuda").to(torch.bfloat16)
            k, v = kv[0], kv[1]
            runs = {
                "ms": lambda: dec.self_attention(q, k, v, keys),
                "plain_ms": lambda: dec.self_attention_ref(q, k, v, keys),
                "library_ms": lambda: F.scaled_dot_product_attention(q[:, :, None], k[:, :, :keys], v[:, :, :keys]),
            }
            bound_ms, bound_by = decode_attention_bound_ms("self", n, h, keys, dh, "bfloat16", peaks)
            plan = dec.plan("self")
        else:
            n = b * DECODE_R
            q = torch.randn(n, h * dh, generator=gen, device="cuda").to(torch.bfloat16).view(n, h, dh)
            kv = torch.randn(2, b, h, keys, dh, generator=gen, device="cuda").to(torch.bfloat16)
            k, v = kv[0], kv[1]
            qb = q.view(b, DECODE_R, h, dh).transpose(1, 2)
            runs = {
                "ms": lambda: dec.cross_attention(q, k, v, DECODE_R),
                "plain_ms": lambda: dec.cross_attention_ref(q, k, v, DECODE_R),
                "library_ms": lambda: F.scaled_dot_product_attention(qb, k, v).transpose(1, 2).reshape(n, -1),
            }
            bound_ms, bound_by = decode_attention_bound_ms("cross", n, h, keys, dh, "bfloat16", peaks, r=DECODE_R)
            plan = dec.plan("cross", keys)
        times = _times(runs, args.iters, args.repeat)
        windows = [_window(runs["ms"], args.iters) for _ in range(args.repeat)]
        library = [_window(runs["library_ms"], args.iters) for _ in range(args.repeat)]
        ms = min(w["device_ms"] for w in windows)
        print(json.dumps({"metric": "decode_attention_timing", "kernel": "K8", "mode": mode, "rows": n, "H": h,
                          "dh": dh, "keys": keys, "card": card, **{key: min(t) for key, t in times.items()},
                          "all": times, "device_ms": ms, "device_all": [w["device_ms"] for w in windows],
                          "launches_a_call": windows[0]["launches_a_call"],
                          "library_device_ms": min(w["device_ms"] for w in library),
                          "library_launches_a_call": library[0]["launches_a_call"], "bound_ms": bound_ms,
                          "bound_by": bound_by, "bound_share": bound_ms / ms, "plan": plan}), flush=True)
        del q, kv, k, v, runs
        torch.cuda.empty_cache()


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--repeat", type=int, default=3)
    p.add_argument("--kernels", nargs="*", default=None, help="time only these (K1 ... K6, K8)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_attention_bench: no CUDA device; it measures the card only")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    peaks = peaks_for(torch.cuda.get_device_name(0))
    bench_attention(args, card, peaks)
    bench_rows(args, card, peaks)
    bench_decode(args, card, peaks)


if __name__ == "__main__":
    main()
