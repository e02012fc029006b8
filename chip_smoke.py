#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It drives ``helping_hand_for_egocentric_videos_torch`` (never JAX, never
the JAX package) through these phases, each printing its own line; any
failed check raises and the script exits non-zero:

1. device: the CUDA device, or exit non-zero; the ``nvidia-smi`` name and
   power limit; TF32 off for matmuls and convolutions.
2. build: every ``csrc/*.cu`` with nvcc (one process per source, all
   started together), with the build seconds and ptxas's register report.
3. kernel vs plain: the divided-attention kernel in both modes at
   (B=2, T=4) and the serving shape (B=8, T=16), N=256, H=16, dh=64, in
   f32 and bf16, against the plain PyTorch version on the same inputs
   (f32 atol 1e-4; bf16 against the plain version in f32 on the bf16
   inputs, atol 2e-2): the patch output and the merged CLS output. The
   inputs are seeded N(0, 1), so the logits have unit spread and the
   softmax is far from uniform (qkv scaled by 0.1 would hide a wrong key
   behind a near-uniform average). At
   the serving shape in bf16 it times the kernel, the plain version, and
   one ``F.scaled_dot_product_attention`` call over [CLS | group keys] as
   a yardstick (the port never calls it), with CUDA events.
4. int8 kernels vs plain: K3 (the attention with its output quantized per
   token, both modes), K4 (LayerNorm -> int8, D=1024) and K5 (QuickGELU ->
   int8, D=4096) at (B=2, T=4) and the serving shape (B=8, T=16, N=256,
   32768 rows), inputs seeded N(0, 1), the LayerNorm gamma 1 + 0.2 N(0, 1)
   and beta 0.1 N(0, 1): scales within rtol 1e-5 of the plain version's,
   codes within 1, at most 0.1% of the codes changed. At the serving shape
   in bf16 each kernel and its plain version are timed with CUDA events.
   Then ``torch._int_mm`` at the qkv shape (32768 x 1024 . 1024 x 3072),
   in both operand layouts, beside ``F.linear`` in bf16, as a line of its
   own (the port's int8 matmul is ``torch._int_mm``).
5. serve: the full-width TimeSformer-L (16 frames) + object decoder from
   seeded random weights behind ``ServingEngine`` and the HTTP server on
   127.0.0.1; text, video, similarity and health requests from several
   threads, then a closed loop of full-bucket video requests. The launch
   counts of every kernel are set to 0 just before and read just after:
   each video forward must launch K1 and K2 24 times each and K3-K5 never.
6. serve int8: the same weights quantized (``EvalModel(int8=True)``), the
   same requests; ``/healthz`` must say ``"int8": true`` and each video
   forward must launch K3 24 times in each mode, K4 72 times, K5 24 times
   and K1/K2 never.
7. end to end vs plain: the same 2 clips through the kernel path and
   through the plain attention (``attention_backend="reference"``): f32
   kernel vs f32 plain within 1e-3 x max|embedding|, bf16 kernel vs f32
   plain with a cosine of at least 0.99 per clip.
8. end to end int8: the same 2 clips through the int8 kernel path (the
   fused route) and the int8 reference path (dynamic int8 at every
   matmul, the JAX package's XLA route): cosine of at least 0.99 per
   clip; and int8 kernel path vs bf16 kernel path with a cosine of at
   least ``INT8_COS_FLOOR``, set before the first run on the card from the
   JAX package's own int8-vs-f32 cosine (``tools/int8_cosine_floor.py``).

9. head-grid kernel vs plain: K6, the time attention of long clips, at
   (B=1, T=128), (B=2, T=128) and forced at (B=2, T=16), N=256, H=16,
   dh=64, f32 and bf16, inputs seeded N(0, 1), against its plain version
   with the tolerances of phase 3; at (B=2, T=128) in bf16 the kernel, the
   plain version and one SDPA call over [CLS | tube] are timed.
10. serve-long: synthetic checkpoints in the reference's layout, at the
   full width of TimeSformer-L (4 frames, as LaviLa releases it) and of the
   13-query decoder (4 frames, with its trajectory head), written under
   ``build/``; ``cli.serve.main`` serves them at ``--num_frames 128``
   (both temporal embeddings inflated) with buckets (1, 2), once in bf16
   and once with ``--int8``: /embed_text, /embed_video with 1 and 2 clips,
   /healthz. The converted weights must equal the written ones. Each video
   forward must launch, in bf16, K1 and K6 24 times and K2 never; with
   ``--int8``, K3-space and K6 24 times, K4 48, K5 24 and K3-time, K1, K2
   never: the JAX package's route at T=128 (``launches_per_forward``
   derives it from the model's own ``_kernel_friendly``).
11. end to end at T=128: phases 7 and 8 on the served models, 2 clips of
   128 frames.

Then one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Time attention is zero-initialised in the model (its qkv feeds
the kernel zeros), so the smoke gives its weights seeded N(0, 0.02) values.
"""

from __future__ import annotations

import io
import json
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np

SEED = 0
N, HEADS, DH = 256, 16, 64
D = HEADS * DH
KERNEL_SHAPES = ((2, 4), (8, 16))  # (B, T); the last is the serving shape
SERVE_T, RES = 16, 224
BUCKETS = (1, 2, 4, 8)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
REPO = "helping_hand_for_egocentric_videos_torch"
TPU_KERNEL = "helping_hand_for_egocentric_videos_tpu/ops/divided_attention.py:103"
TPU_ACT_QUANT = "helping_hand_for_egocentric_videos_tpu/ops/act_quant.py"
ROWS_SHAPES = ((2, 4), (8, 16))  # (B, T) of the int8 checks: B*T*N rows
HEADGRID_SHAPES = ((1, 128), (2, 128), (2, 16))  # (B, T); T=16 forced, T=128 the long clips
TPU_HEADGRID = "helping_hand_for_egocentric_videos_tpu/ops/divided_attention.py:312"
LONG_T, LONG_BUCKETS, CKPT_T = 128, (1, 2), 4
BUILD = Path(__file__).resolve().parent / "build"
MLP = 4 * D
# int8 kernel path vs bf16 kernel path, least cosine per clip: the JAX
# package's own int8-vs-f32 cosine at full depth and width (4 frames, CPU,
# tools/int8_cosine_floor.py) less a margin; see PERF.md
INT8_COS_FLOOR = 0.9899
# Dense peaks from NVIDIA's data sheets: memory bytes/s and ops/s by type.
PEAKS = {
    "sxm": {"bytes": 3.35e12, "bfloat16": 989e12, "float32": 67e12},
    "pcie": {"bytes": 2.0e12, "bfloat16": 756e12, "float32": 51e12},
}


def say(phase: str, **kw):
    print(f"[{phase}] " + json.dumps(kw), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke runs only on an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    say("device", name=name, count=torch.cuda.device_count(), card=card, torch=torch.__version__,
        cuda=torch.version.cuda)
    return name, card


def phase_build():
    from helping_hand_for_egocentric_videos_torch.ops import _build

    t0 = time.perf_counter()
    res = _build.build_all(verbose=True)
    for name, r in res.items():
        ptxas = [ln.strip() for ln in r["log"].splitlines() if "registers" in ln or "spill" in ln]
        say("build", source=f"csrc/{name}.cu", seconds=round(r["seconds"], 3), ptxas=ptxas)
    say("build", total_seconds=round(time.perf_counter() - t0, 3))


def _sdpa_inputs(qkv, ck, cv, mode):
    """Head-major q and [CLS | group] k, v for F.scaled_dot_product_attention."""
    import torch

    b, t, n, _ = qkv.shape
    q, k, v = qkv.reshape(b, t, n, 3, HEADS, DH).unbind(3)
    perm, g, w = ((0, 1, 3, 2, 4), t, n) if mode == "space" else ((0, 2, 3, 1, 4), n, t)

    def grp(z):
        return z.permute(*perm).reshape(b * g, HEADS, w, DH)

    def with_cls(c, z):
        c = c.reshape(b, 1, HEADS, 1, DH).expand(b, g, HEADS, 1, DH).reshape(b * g, HEADS, 1, DH)
        return torch.cat([c, grp(z)], dim=2).contiguous()

    return grp(q).contiguous(), with_cls(ck, k), with_cls(cv, v)


def _bound_ms(qkv, mode, peaks, quant_out=False) -> tuple[float, str]:
    b, t, n, d3 = qkv.shape
    es = qkv.element_size()
    g, w = (t, n) if mode == "space" else (n, t)
    # the output: D values of the input type a token, or D codes and a scale
    out_bytes = b * t * n * ((D + 4) if quant_out else D * es)
    nbytes = qkv.numel() * es + 3 * b * D * es + out_bytes + b * g * HEADS * (2 + DH) * 4
    # QK and PV over w + 1 keys for every patch query, and the CLS query over w keys per group
    flops = 4 * b * t * n * HEADS * DH * (w + 2)
    by_bytes = nbytes / peaks["bytes"]
    by_ops = flops / peaks[str(qkv.dtype).removeprefix("torch.")]
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def phase_kernels(device, peaks):
    import torch
    import torch.nn.functional as F

    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    gen = torch.Generator(device=device).manual_seed(SEED)
    report = {}
    for mode in ("space", "time"):
        checks = []
        for b, t in KERNEL_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).removeprefix("torch.")
                qkv = torch.randn(b, t, N, 3 * D, generator=gen, device=device).to(dtype)
                ck, cv, cq = (torch.randn(b, D, generator=gen, device=device).to(dtype) for _ in range(3))
                out, parts = da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=HEADS)
                cls = da.merge_cls_partials(*parts, cq, ck, cv, HEADS)
                f32 = [z.float() for z in (qkv, ck, cv, cq)]
                ref, ref_parts = da.divided_patch_attention_ref(*f32, mode=mode, heads=HEADS)
                ref_cls = da.merge_cls_partials(*ref_parts, *f32[3:], *f32[1:3], HEADS)
                torch.cuda.synchronize()
                err = max((out.float() - ref).abs().max().item(), (cls - ref_cls).abs().max().item())
                finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(cls).all())
                check = {"B": b, "T": t, "dtype": dname, "max_abs_err": err, "tolerance": TOL[dname]}
                say("kernel-vs-plain", mode=mode, **check)
                if not finite or not err <= TOL[dname]:
                    raise AssertionError(f"{mode} kernel disagrees with the plain version: {check}")
                checks.append(check)
        # timing at the serving shape in the serving type (the last inputs made)
        q, k, v = _sdpa_inputs(qkv, ck, cv, mode)
        lib_out = F.scaled_dot_product_attention(q, k, v)
        ms = cuda_ms(lambda: da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=HEADS), 20)
        plain_ms = cuda_ms(lambda: da.divided_patch_attention_ref(qkv, ck, cv, cq, mode=mode, heads=HEADS), 5)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
        bound_ms, bound_by = _bound_ms(qkv, mode, peaks)
        perm = (0, 1, 3, 2, 4) if mode == "space" else (0, 3, 1, 2, 4)
        b, t = qkv.shape[:2]
        g = t if mode == "space" else N
        lib_as_out = lib_out.reshape(b, g, HEADS, -1, DH).permute(*perm).reshape(b, t, N, D)
        report[mode] = {
            "name": f"divided_attention_{mode}",
            "route": "cuda",
            "source": f"{REPO}/csrc/divided_attention.cu",
            "replaces": TPU_KERNEL,
            "launches": None,
            "max_abs_err": checks[-1]["max_abs_err"],
            "tolerance": checks[-1]["tolerance"],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
            "library_max_abs_err": (lib_as_out.float() - ref).abs().max().item(),
            "timed_at": {"B": b, "T": t, "N": N, "H": HEADS, "dh": DH, "dtype": "bfloat16"},
            "checks": checks,
        }
        say("kernel-timing", mode=mode, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by)
        del qkv, ck, cv, cq, q, k, v, lib_out, ref, ref_parts
        torch.cuda.empty_cache()
    return report


def _quant_check(got, want) -> dict:
    """Quantized outputs (codes int8, scales f32) of a kernel against its
    plain version on the same inputs."""
    import torch

    (q, s), (wq, ws) = got, want
    diff = (q.int() - wq.int()).abs()
    res = {
        "scale_max_rel_err": ((s - ws).abs() / ws.abs()).max().item(),
        "code_max_diff": diff.max().item(),
        "codes_changed": diff.count_nonzero().item() / diff.numel(),
        "max_abs_err": (q.float() * s - wq.float() * ws).abs().max().item(),
        "finite": bool(torch.isfinite(s).all()),
    }
    res["ok"] = (res["finite"] and res["scale_max_rel_err"] <= 1e-5 and res["code_max_diff"] <= 1
                 and res["codes_changed"] <= 1e-3)
    return res


def _rows_bound_ms(rows, d, in_bytes, ops_per_value, peaks) -> tuple[float, str]:
    """A per-row quantizing pass: read the rows once, write a code a value
    and a scale a row; f32 arithmetic outside the tensor cores."""
    nbytes = rows * d * (in_bytes + 1) + rows * 4
    by_bytes, by_ops = nbytes / peaks["bytes"], rows * d * ops_per_value / peaks["float32"]
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def phase_int8_kernels(device, peaks):
    """K3 (both modes), K4 and K5 against their plain versions; timings at
    the serving shape in bf16."""
    import torch
    from torch import nn

    from helping_hand_for_egocentric_videos_torch.ops import act_quant as aq
    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    report = {}

    def check(name, got, want, **shape):
        res = _quant_check(got, want)
        say("kernel-vs-plain", kernel=name, **shape, **res)
        if not res["ok"]:
            raise AssertionError(f"{name} disagrees with its plain version: {shape} {res}")
        return res

    def entry(name, source, replaces, last, timed, fn, plain, bound):
        ms, plain_ms = cuda_ms(fn, 20), cuda_ms(plain, 5)
        bound_ms, bound_by = bound
        say("kernel-timing", kernel=name, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        return {
            "name": name, "route": "cuda", "source": f"{REPO}/{source}", "replaces": replaces,
            "launches": None, "max_abs_err": last["max_abs_err"],
            "tolerance": "scales rtol 1e-5, codes within 1, <= 0.1% of codes changed",
            "codes_changed": last["codes_changed"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "timed_at": {**timed, "dtype": "bfloat16"},
        }

    # K3: the attention output quantized per token over all heads
    for mode in ("space", "time"):
        for b, t in KERNEL_SHAPES:
            for dtype in ((torch.float32, torch.bfloat16) if b * t < 64 else (torch.bfloat16,)):
                qkv = torch.randn(b, t, N, 3 * D, generator=gen, device=device).to(dtype)
                ck, cv, cq = (torch.randn(b, D, generator=gen, device=device).to(dtype) for _ in range(3))
                got, parts = da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=HEADS, quant_out=True)
                _, parts0 = da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=HEADS)
                want, _ = da.divided_patch_attention_ref(qkv, ck, cv, cq, mode=mode, heads=HEADS, quant_out=True)
                torch.cuda.synchronize()
                same = all(torch.equal(x, y) for x, y in zip(parts, parts0))
                last = check(f"divided_attention_{mode}_int8", got, want, B=b, T=t,
                             dtype=str(dtype).removeprefix("torch."), partials_as_without_quant=same)
                if not same:
                    raise AssertionError(f"K3 {mode}: the CLS partials differ from K1/K2's")
        report[f"{mode}_int8"] = entry(
            f"divided_attention_{mode}_int8", "csrc/divided_attention.cu",
            "helping_hand_for_egocentric_videos_tpu/ops/divided_attention.py:243", last,
            {"B": b, "T": t, "N": N, "H": HEADS, "dh": DH},
            lambda: da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=HEADS, quant_out=True),
            lambda: da.divided_patch_attention_ref(qkv, ck, cv, cq, mode=mode, heads=HEADS, quant_out=True),
            _bound_ms(qkv, mode, peaks, quant_out=True),
        )
        del qkv, ck, cv, cq, got, want, parts, parts0
        torch.cuda.empty_cache()

    # K4 at D = 1024 and K5 at D = 4096, on B*T*N rows
    ln = nn.LayerNorm(D, device=device)
    with torch.no_grad():
        ln.weight.copy_(1.0 + 0.2 * torch.randn(D, generator=gen, device=device))
        ln.bias.copy_(0.1 * torch.randn(D, generator=gen, device=device))
    for name, d, ops, fn, plain, line in (
        ("layer_norm_int8", D, 14, lambda x: aq.layer_norm_int8(ln, x, 1e-6),
         lambda x: aq.layer_norm_int8_ref(ln, x, 1e-6), 45),
        ("quick_gelu_int8", MLP, 12, aq.quick_gelu_int8, aq.quick_gelu_int8_ref, 57),
    ):
        for b, t in ROWS_SHAPES:
            for dtype in ((torch.float32, torch.bfloat16) if b * t < 64 else (torch.bfloat16,)):
                x = torch.randn(b * t * N, d, generator=gen, device=device).to(dtype)
                got, want = fn(x), plain(x)
                torch.cuda.synchronize()
                last = check(name, got, want, rows=x.shape[0], D=d, dtype=str(dtype).removeprefix("torch."))
        report[name] = entry(
            name, "csrc/act_quant.cu", f"{TPU_ACT_QUANT}:{line}", last, {"rows": x.shape[0], "D": d},
            lambda: fn(x), lambda: plain(x), _rows_bound_ms(x.shape[0], d, x.element_size(), ops, peaks),
        )
        del x, got, want
        torch.cuda.empty_cache()
    return report


def phase_headgrid(device, peaks):
    """K6 against its plain version; timing at (B=2, T=128) in bf16."""
    import torch
    import torch.nn.functional as F

    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    checks = []
    for b, t in HEADGRID_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            qkv = torch.randn(b, t, N, 3 * D, generator=gen, device=device).to(dtype)
            ck, cv, cq = (torch.randn(b, D, generator=gen, device=device).to(dtype) for _ in range(3))
            out, parts = da.divided_patch_attention(qkv, ck, cv, cq, mode="time", heads=HEADS, head_grid=True)
            cls = da.merge_cls_partials(*parts, cq, ck, cv, HEADS)
            f32 = [z.float() for z in (qkv, ck, cv, cq)]
            ref, ref_parts = da.time_attention_headgrid_ref(*f32, heads=HEADS)
            ref_cls = da.merge_cls_partials(*ref_parts, *f32[3:], *f32[1:3], HEADS)
            torch.cuda.synchronize()
            err = max((out.float() - ref).abs().max().item(), (cls - ref_cls).abs().max().item())
            finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(cls).all())
            check = {"B": b, "T": t, "dtype": dname, "head_grid_by_default": da.needs_head_grid(t, N, HEADS),
                     "max_abs_err": err, "tolerance": TOL[dname]}
            say("kernel-vs-plain", kernel="time_attention_headgrid", **check)
            if not finite or not err <= TOL[dname] or tuple(parts[0].shape) != (b, N, HEADS, 1):
                raise AssertionError(f"the head-grid kernel disagrees with its plain version: {check}")
            checks.append(check)
            if (b, t, dtype) == (2, LONG_T, torch.bfloat16):
                timed = (qkv, ck, cv, cq, ref, check)
            del qkv, ck, cv, cq, out, parts, ref, ref_parts, f32
    qkv, ck, cv, cq, ref, check = timed
    q, k, v = _sdpa_inputs(qkv, ck, cv, "time")
    lib_out = F.scaled_dot_product_attention(q, k, v)
    ms = cuda_ms(lambda: da.divided_patch_attention(qkv, ck, cv, cq, mode="time", heads=HEADS), 20)
    plain_ms = cuda_ms(lambda: da.time_attention_headgrid_ref(qkv, ck, cv, cq, heads=HEADS), 5)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
    bound_ms, bound_by = _bound_ms(qkv, "time", peaks)
    b, t = qkv.shape[:2]
    lib_as_out = lib_out.reshape(b, N, HEADS, t, DH).permute(0, 3, 1, 2, 4).reshape(b, t, N, D)
    say("kernel-timing", kernel="time_attention_headgrid", ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by=bound_by)
    entry = {
        "name": "time_attention_headgrid", "route": "cuda",
        "source": f"{REPO}/csrc/divided_attention_long.cu", "replaces": TPU_HEADGRID,
        "launches": None, "max_abs_err": check["max_abs_err"], "tolerance": check["tolerance"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "library_max_abs_err": (lib_as_out.float() - ref).abs().max().item(),
        "timed_at": {"B": b, "T": t, "N": N, "H": HEADS, "dh": DH, "dtype": "bfloat16"}, "checks": checks,
    }
    del timed, qkv, ck, cv, cq, ref, q, k, v, lib_out, lib_as_out
    torch.cuda.empty_cache()
    return entry


def phase_int_mm(device, peaks):
    """``torch._int_mm`` at the serving qkv shape in both layouts of the
    weight, beside the bf16 ``F.linear`` of the same shape: a line of its
    own (the port's int8 matmul; no kernel of the port)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    m, k, n = 8 * SERVE_T * N, D, 3 * D
    a = torch.randint(-127, 128, (m, k), generator=gen, device=device, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, device=device, dtype=torch.int8)
    w_kn = w.t().contiguous()
    exact = torch.equal(torch._int_mm(a[:64], w.t()), (a[:64].float() @ w.float().t()).int())
    exact = exact and torch.equal(torch._int_mm(a[:64], w_kn), (a[:64].float() @ w_kn.float()).int())
    x = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
    wb = torch.randn(n, k, generator=gen, device=device).to(torch.bfloat16)
    ms = {
        "int_mm_w_nk_transposed": cuda_ms(lambda: torch._int_mm(a, w.t()), 20),
        "int_mm_w_kn_contiguous": cuda_ms(lambda: torch._int_mm(a, w_kn), 20),
        "linear_bf16": cuda_ms(lambda: F.linear(x, wb), 20),
    }
    ops = 2 * m * k * n
    say("int-mm", M=m, K=k, N=n, exact=exact, ms=ms,
        tops={key: ops / (v * 1e-3) / 1e12 for key, v in ms.items()},
        bound_ms={"int8": 1e3 * ops / 1979e12, "bfloat16": 1e3 * ops / peaks["bfloat16"]})
    if not exact:
        raise AssertionError("torch._int_mm disagrees with an exact float product")


def build_serving_model(device):
    import torch

    from helping_hand_for_egocentric_videos_torch.data import ClipTokenizer
    from helping_hand_for_egocentric_videos_torch.models import (
        DecoderConfig,
        Lavila,
        ObjDecoder,
        timesformer_large_config,
    )
    from helping_hand_for_egocentric_videos_torch.train import EvalModel

    lcfg = timesformer_large_config(num_frames=SERVE_T)
    dcfg = DecoderConfig(num_queries=13, feature_dim=1024, text_width=768, num_frames=SERVE_T,
                         pred_traj=False)
    gen = torch.Generator(device=device).manual_seed(SEED)
    backbone = Lavila(lcfg, generator=gen, device=device)
    decoder = ObjDecoder(dcfg, generator=gen, device=device)
    with torch.no_grad():  # the smoke's choice of weights: a non-zero time attention
        for blk in backbone.visual.blocks:
            blk.timeattn.qkv.weight.normal_(0.0, 0.02, generator=gen)
            blk.timeattn.proj.weight.normal_(0.0, 0.02, generator=gen)
    return EvalModel(backbone, lcfg, decoder, dcfg, ClipTokenizer(), input_res=RES, device=device)


def _request(base, path, body=None, content_type="application/json"):
    t0 = time.perf_counter()
    req = urllib.request.Request(base + path, data=body, headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=600) as r:
        out = json.loads(r.read())
        code = r.status
    return {"path": path, "code": code, "seconds": time.perf_counter() - t0, "out": out}


def _npy(a) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _check_embed_video(res, n, embed_dim, nq):
    emb = np.asarray(res["out"]["embeddings"])
    if res["code"] != 200 or emb.shape != (n, embed_dim) or not np.isfinite(emb).all():
        raise AssertionError(f"bad /embed_video answer: code {res['code']}, shape {emb.shape}")
    if "boxes" in res["out"]:
        boxes = np.asarray(res["out"]["boxes"])
        if boxes.shape != (n, nq, 4) or not (np.isfinite(boxes).all() and (0 <= boxes).all() and (boxes <= 1).all()):
            raise AssertionError(f"bad boxes: shape {boxes.shape}")


def _counters():
    """Every kernel's launch count: (wrapper, attribute) by kernel name."""
    from helping_hand_for_egocentric_videos_torch.ops import act_quant as aq
    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    f = da.divided_patch_attention
    return {
        "divided_attention_space": (f, "launches_space"),
        "divided_attention_time": (f, "launches_time"),
        "divided_attention_space_int8": (f, "launches_space_quant"),
        "divided_attention_time_int8": (f, "launches_time_quant"),
        "layer_norm_int8": (aq.layer_norm_int8, "launches"),
        "quick_gelu_int8": (aq.quick_gelu_int8, "launches"),
        "time_attention_headgrid": (f, "launches_time_headgrid"),
    }


def reset_counts():
    for obj, attr in _counters().values():
        setattr(obj, attr, 0)


def read_counts() -> dict:
    return {name: getattr(obj, attr) for name, (obj, attr) in _counters().items()}


def launches_per_forward(model) -> dict:
    """What one video forward must launch, once a block each: the time
    kernel is K6 where ``needs_head_grid`` holds, else K2; space attention
    is K1. A pure int8 tower takes the JAX package's route per mode, from
    the model's own ``_kernel_friendly``: a fused mode runs K4 then K3, a
    fused MLP K4 then K5; an unfused mode runs K1, K2 or K6. At 16 frames
    that is K3 24 + 24, K4 72, K5 24; at 128 frames K3-space 24, K6 24,
    K4 48, K5 24."""
    from helping_hand_for_egocentric_videos_torch.models.spacetime_vit import _kernel_friendly
    from helping_hand_for_egocentric_videos_torch.ops.divided_attention import needs_head_grid

    cfg = model.lavila_cfg.visual
    depth, t, n, d = cfg.depth, cfg.num_frames, cfg.patches_per_frame, cfg.width
    plain = {"space": "divided_attention_space",
             "time": "time_attention_headgrid" if needs_head_grid(t, n, cfg.heads) else "divided_attention_time"}
    want = dict.fromkeys(_counters(), 0)
    fused = {m: model.int8 and d % 128 == 0 and _kernel_friendly(n, d, cfg.heads, t, m) for m in plain}
    for m, kernel in plain.items():
        if fused[m]:
            want[f"divided_attention_{m}_int8"] += depth
            want["layer_norm_int8"] += depth
        else:
            want[kernel] += depth
    if fused["space"]:  # the MLP: K4 -> fc1 -> K5 -> fc2
        want["layer_norm_int8"] += depth
        want["quick_gelu_int8"] += depth
    return want


def phase_serve(model, card, device):
    import torch

    from helping_hand_for_egocentric_videos_torch.serve import ServeConfig, ServingEngine
    from helping_hand_for_egocentric_videos_torch.serve.server import make_server

    t_frames, res = model.lavila_cfg.visual.num_frames, model.input_res
    embed_dim, nq = model.dec_cfg.embed_dim, model.dec_cfg.num_queries
    engine = ServingEngine(model, video_shape=(t_frames, res, res, 3), cfg=ServeConfig(buckets=BUCKETS))
    srv = make_server(engine, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    rng = np.random.default_rng(SEED)

    def clips(n):
        return rng.integers(0, 256, size=(n, t_frames, res, res, 3), dtype=np.uint8)

    try:
        t0 = time.perf_counter()
        engine.warmup()
        warmup_s = time.perf_counter() - t0
        texts = ["#C C cuts the onion on the board", "#C C opens the fridge", "wash hands"]
        jobs = [
            ("/embed_text", json.dumps({"texts": texts[:2]}).encode(), "application/json", None),
            ("/embed_text", json.dumps({"texts": texts}).encode(), "application/json", None),
            ("/embed_video?boxes=1", _npy(clips(1)), "application/x-npy", 1),
            ("/embed_video", _npy(clips(3)), "application/x-npy", 3),
            ("/embed_video?boxes=1", _npy(clips(8)), "application/x-npy", 8),
        ]
        buf = io.BytesIO()
        np.savez(buf, video=clips(2), texts=np.asarray(texts[:2]))
        loop = [_npy(clips(BUCKETS[-1])) for _ in range(4)]
        torch.cuda.synchronize(device)
        calls0 = engine.stats["video"].snapshot()["device_calls"]

        # ---- the main path: counts set to 0 just before, read just after
        reset_counts()
        with ThreadPoolExecutor(max_workers=len(jobs) + 2) as pool:
            futs = [pool.submit(_request, base, p, body, ct) for p, body, ct, _ in jobs]
            futs.append(pool.submit(_request, base, "/similarity", buf.getvalue(), "application/x-npz"))
            futs.append(pool.submit(lambda: _request(base, "/healthz")))
            concurrent = [f.result() for f in futs]
        t0 = time.perf_counter()
        closed = [_request(base, "/embed_video", body, "application/x-npy") for body in loop]
        loop_s = time.perf_counter() - t0
        torch.cuda.synchronize(device)
        launches = read_counts()
        video_calls = engine.stats["video"].snapshot()["device_calls"] - calls0
        # ----
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()
        th.join(timeout=30)

    for r, (_, _, _, n) in zip(concurrent, jobs):
        if n is None:
            emb = np.asarray(r["out"]["embeddings"])
            if r["code"] != 200 or emb.shape[1:] != (embed_dim,) or not np.isfinite(emb).all():
                raise AssertionError(f"bad /embed_text answer: {r['code']} {emb.shape}")
        else:
            _check_embed_video(r, n, embed_dim, nq)
    sim = np.asarray(concurrent[-2]["out"]["sim"])
    if sim.shape != (2, 2) or not (np.isfinite(sim).all() and (np.abs(sim) <= 1 + 1e-5).all()):
        raise AssertionError(f"bad /similarity answer: {sim}")
    health = concurrent[-1]["out"]
    if (health["status"] != "ok" or health["backend"] != torch.device(device).type
            or health["int8"] is not model.int8):
        raise AssertionError(f"bad /healthz answer: {health}")
    for r in closed:
        _check_embed_video(r, BUCKETS[-1], embed_dim, nq)
    per_forward = launches_per_forward(model)
    if video_calls < 1 or launches != {k: v * video_calls for k, v in per_forward.items()}:
        raise AssertionError(f"{launches} launches for {video_calls} video forwards, want {per_forward} per forward")

    latency = [{"path": r["path"].split("?")[0], "seconds": r["seconds"]} for r in concurrent + closed]
    clips_per_s = len(closed) * BUCKETS[-1] / loop_s
    say("serve-int8" if model.int8 else "serve", card=card, warmup_seconds=warmup_s,
        video_forwards=video_calls, launches=launches, launches_per_forward=per_forward,
        closed_loop={"requests": len(closed), "clips_per_request": BUCKETS[-1], "seconds": loop_s,
                     "clips_per_s": clips_per_s},
        latency=latency)
    return launches


def phase_end_to_end(model, device, phase="end-to-end"):
    import torch

    from helping_hand_for_egocentric_videos_torch.train import EvalModel

    lcfg = model.lavila_cfg
    plain_cfg = replace(lcfg, visual=replace(lcfg.visual, attention_backend="reference"))
    kw = dict(input_res=model.input_res, dtype=torch.float32, device=device)
    k32 = EvalModel(model.backbone, lcfg, model.decoder, model.dec_cfg, model.tokenizer, **kw)
    p32 = EvalModel(model.backbone, plain_cfg, model.decoder, model.dec_cfg, model.tokenizer, **kw)
    rng = np.random.default_rng(SEED + 1)
    t_frames, res = lcfg.visual.num_frames, model.input_res
    clips = rng.integers(0, 256, size=(2, t_frames, res, res, 3), dtype=np.uint8)
    plain, _ = p32.embed_video(clips)
    kern32, _ = k32.embed_video(clips)
    kern16, _ = model.embed_video(clips)
    diff = float(np.abs(kern32 - plain).max())
    limit = 1e-3 * float(np.abs(plain).max())
    cos = (kern16 * plain).sum(-1) / (np.linalg.norm(kern16, axis=-1) * np.linalg.norm(plain, axis=-1))
    say(phase, frames=t_frames, f32_max_abs_diff=diff, f32_limit=limit, bf16_cosine=cos.tolist(),
        cosine_limit=0.99)
    if not (np.isfinite(plain).all() and diff <= limit):
        raise AssertionError(f"f32 kernel path vs plain: {diff} > {limit}")
    if not (cos >= 0.99).all():
        raise AssertionError(f"bf16 kernel path vs f32 plain: cosine {cos}")


def _cosine(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def phase_end_to_end_int8(model8, model, device, phase="end-to-end-int8"):
    """The int8 kernel path against the int8 reference path and against
    the bf16 kernel path, on the same 2 clips."""
    from helping_hand_for_egocentric_videos_torch.train import EvalModel

    lcfg = model.lavila_cfg
    plain_cfg = replace(lcfg, visual=replace(lcfg.visual, attention_backend="reference"))
    ref8 = EvalModel(model.backbone, plain_cfg, model.decoder, model.dec_cfg, model.tokenizer,
                     input_res=model.input_res, device=device, int8=True)
    rng = np.random.default_rng(SEED + 1)
    t_frames, res = lcfg.visual.num_frames, model.input_res
    clips = rng.integers(0, 256, size=(2, t_frames, res, res, 3), dtype=np.uint8)
    kern8, _ = model8.embed_video(clips)
    plain8, _ = ref8.embed_video(clips)
    kern16, _ = model.embed_video(clips)
    cos_ref, cos_bf16 = _cosine(kern8, plain8), _cosine(kern8, kern16)
    say(phase, frames=t_frames, int8_kernel_vs_int8_reference_cosine=cos_ref.tolist(), reference_limit=0.99,
        int8_kernel_vs_bf16_kernel_cosine=cos_bf16.tolist(), bf16_limit=INT8_COS_FLOOR)
    if not (np.isfinite(kern8).all() and (cos_ref >= 0.99).all()):
        raise AssertionError(f"int8 kernel path vs int8 reference path: cosine {cos_ref}")
    if not (cos_bf16 >= INT8_COS_FLOOR).all():
        raise AssertionError(f"int8 kernel path vs bf16 kernel path: cosine {cos_bf16} < {INT8_COS_FLOOR}")


def _pack_mha(sd: dict) -> dict:
    """The port's per-matrix wq/wk/wv Linears -> torch's packed in_proj."""
    import torch

    for key in [k for k in sd if k.endswith(".wq.weight")]:
        pre = key.removesuffix("wq.weight")
        for f in ("weight", "bias"):
            sd[f"{pre}in_proj_{f}"] = torch.cat([sd.pop(f"{pre}{w}.{f}") for w in ("wq", "wk", "wv")])
            sd[f"{pre}out_proj.{f}"] = sd.pop(f"{pre}wo.{f}")
    return sd


# the port's state-dict names -> the reference's (model/LaviLa.py, the decoder's .pth.tar)
_LAVILA_NAMES = ((r"^visual\.(blocks\.\d+)\.mlp_fc(\d)", r"visual.\1.mlp.fc\2"),
                 (r"^text\.blocks\.", "transformer.resblocks."), (r"\.mlp_fc\.", ".mlp.c_fc."),
                 (r"\.mlp_proj\.", ".mlp.c_proj."), (r"^text\.token_embedding$", "token_embedding.weight"),
                 (r"^text\.", ""))
_DECODER_NAMES = ((r"^pre_norm\.", "transformer.pre_norm."), (r"^decoder_norm\.", "transformer.decoder.norm."),
                  (r"^layers\.", "transformer.decoder.layers."), (r"\.cross_attn\.", ".multihead_attn."),
                  (r"^(query_embed|frame_index|query_index)$", r"\1.weight"),
                  (r"^bbox_mlp\.", "bbox_embed.layers."), (r"^txt_proj\.", "txt_proj.1."),
                  (r"^vid_proj\.", "vid_proj.0."), (r"^obj_proj\.1\.", "obj_proj.2."))


def reference_state_dicts(backbone, decoder, vcfg) -> tuple[dict, dict]:
    """The port's ``Lavila`` and ``ObjDecoder`` -> f32 CPU state dicts in the
    reference's layout, the inverse of ``models/weights.py``: the flat
    channel-last patch Linear back to the (D, C, P, P) conv, q/k/v packed."""
    def rename(sd, names):
        out = {}
        for k, v in sd.items():
            for pat, rep in names:
                k = re.sub(pat, rep, k)
            out[k] = v.detach().float().cpu()
        return _pack_mha(out)

    lsd = rename(backbone.state_dict(), _LAVILA_NAMES)
    w = lsd.pop("visual.patch_embed.weight")
    p = vcfg.patch_size
    lsd["visual.patch_embed.proj.weight"] = w.reshape(w.shape[0], p, p, vcfg.in_chans).permute(0, 3, 1, 2).contiguous()
    return lsd, rename(decoder.state_dict(), _DECODER_NAMES)


def _serve_cli(argv, card):
    """``cli.serve.main(argv)`` in a thread, through its ready/stop hooks:
    text, 1-clip and 2-clip video and health requests with the launch
    counts set to 0 just before and read just after. -> (the served
    EvalModel, launches)."""
    import torch

    from helping_hand_for_egocentric_videos_torch.cli import serve

    started, stop, box = threading.Event(), threading.Event(), {}

    def ready(srv, engine):
        box.update(base=f"http://127.0.0.1:{srv.server_address[1]}", engine=engine)
        started.set()

    def run():
        try:
            serve.main(argv, ready=ready, stop=stop)
        except BaseException as e:  # surfaced to the caller below
            box["error"] = e
            started.set()

    t0 = time.perf_counter()
    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        if not started.wait(timeout=600) or "error" in box:
            raise RuntimeError(f"cli.serve did not come up: {box.get('error')!r}") from box.get("error")
        startup_s = time.perf_counter() - t0
        engine, base = box["engine"], box["base"]
        model = engine.model
        t_frames, res = model.lavila_cfg.visual.num_frames, model.input_res
        rng = np.random.default_rng(SEED + 6)
        clips = {n: _npy(rng.integers(0, 256, size=(n, t_frames, res, res, 3), dtype=np.uint8)) for n in (1, 2)}
        text = json.dumps({"texts": ["#C C cuts the onion on the board", "wash hands"]}).encode()
        torch.cuda.synchronize()
        calls0 = engine.stats["video"].snapshot()["device_calls"]

        # ---- the main path: counts set to 0 just before, read just after
        reset_counts()
        res_text = _request(base, "/embed_text", text)
        res_video = [_request(base, "/embed_video", clips[1], "application/x-npy"),
                     _request(base, "/embed_video?boxes=1", clips[2], "application/x-npy")]
        res_health = _request(base, "/healthz")
        torch.cuda.synchronize()
        launches = read_counts()
        video_calls = engine.stats["video"].snapshot()["device_calls"] - calls0
        # ----
    finally:
        stop.set()
        th.join(timeout=120)
    if th.is_alive():
        raise RuntimeError("cli.serve did not stop")

    emb = np.asarray(res_text["out"]["embeddings"])
    if res_text["code"] != 200 or emb.shape != (2, model.dec_cfg.embed_dim) or not np.isfinite(emb).all():
        raise AssertionError(f"bad /embed_text answer: {res_text['code']} {emb.shape}")
    for r, n in zip(res_video, (1, 2)):
        _check_embed_video(r, n, model.dec_cfg.embed_dim, model.dec_cfg.num_queries)
    health = res_health["out"]
    if health["status"] != "ok" or health["backend"] != model.device.type or health["int8"] is not model.int8 \
            or health["video_shape"] != [t_frames, res, res, 3]:
        raise AssertionError(f"bad /healthz answer: {health}")
    per_forward = launches_per_forward(model)
    if video_calls < 1 or launches != {k: v * video_calls for k, v in per_forward.items()}:
        raise AssertionError(f"{launches} launches for {video_calls} video forwards, want {per_forward} per forward")
    say("serve-long-int8" if model.int8 else "serve-long", card=card, frames=t_frames,
        startup_seconds=startup_s, video_forwards=video_calls, launches=launches,
        launches_per_forward=per_forward,
        latency=[{"path": r["path"].split("?")[0], "seconds": r["seconds"]}
                 for r in (res_text, *res_video, res_health)])
    return model, launches


def phase_serve_long(card, device="cuda", backbone="timesformer_large", frames=LONG_T):
    """Write reference-layout checkpoints of seeded random weights at 4
    frames, then serve them with ``cli.serve`` at ``frames`` in bf16 and
    in int8. -> (bf16 model, int8 model, launches of the two runs)."""
    import torch

    from helping_hand_for_egocentric_videos_torch.models import DecoderConfig, Lavila, ObjDecoder, lavila

    # the CLI's projection width (its ExperimentConfig), 256
    lcfg = getattr(lavila, f"{backbone}_config")(num_frames=CKPT_T, project_embed_dim=256)
    dcfg = DecoderConfig(num_queries=13, feature_dim=lcfg.visual.width, text_width=lcfg.text.width,
                         num_frames=CKPT_T, patches_per_frame=lcfg.visual.patches_per_frame, pred_traj=True)
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    model = Lavila(lcfg, generator=gen, device=device)
    decoder = ObjDecoder(dcfg, generator=gen, device=device)
    with torch.no_grad():  # as build_serving_model: a non-zero time attention
        for blk in model.visual.blocks:
            blk.timeattn.qkv.weight.normal_(0.0, 0.02, generator=gen)
            blk.timeattn.proj.weight.normal_(0.0, 0.02, generator=gen)
        model.visual.temporal_embed.normal_(0.0, 0.02, generator=gen)  # so the inflation shows
    BUILD.mkdir(exist_ok=True)
    served = {}
    with tempfile.TemporaryDirectory(dir=BUILD, prefix="serve_long_") as tmp:
        t0 = time.perf_counter()
        lsd, dsd = reference_state_dicts(model, decoder, lcfg.visual)
        bpath, dpath = f"{tmp}/lavila_{backbone}_{CKPT_T}f.pth", f"{tmp}/decoder_nq12_{CKPT_T}f.pth.tar"
        torch.save({f"module.{k}": v for k, v in lsd.items()}, bpath)
        torch.save({"state_dict": dsd, "epoch": 0}, dpath)
        write_s = time.perf_counter() - t0
        del lsd, dsd
        argv = ["--backbone", backbone, "--backbone_ckpt", bpath, "--decoder_ckpt", dpath,
                "--num_frames", str(frames), "--buckets", *map(str, LONG_BUCKETS), "--port", "0",
                "--device", device]
        for int8 in (False, True):
            served[int8] = _serve_cli(argv + (["--int8"] if int8 else []), card)
    # the converted weights are the written ones (the inflated temporal embeddings aside)
    m16 = served[False][0]
    mismatch = [k for src, dst in ((model, m16.backbone), (decoder, m16.decoder))
                for k, v in src.state_dict().items()
                if not k.endswith("temporal_embed") and not torch.equal(v, dst.state_dict()[k])]
    if mismatch:
        raise AssertionError(f"the converted checkpoint differs from the written weights: {mismatch[:5]}")
    say("serve-long-checkpoints", checkpoint_frames=CKPT_T, frames=frames, write_seconds=write_s,
        parameters=sum(p.numel() for p in model.parameters()) + sum(p.numel() for p in decoder.parameters()),
        round_trip_equal=True)
    del model, decoder
    return served[False][0], served[True][0], {k: served[False][1][k] + served[True][1][k] for k in _counters()}


def main():
    name, card = phase_device()
    import torch

    from helping_hand_for_egocentric_videos_torch.train import EvalModel

    peaks = PEAKS["pcie" if "pcie" in name.lower() else "sxm"]
    phase_build()
    report = phase_kernels("cuda", peaks)
    report.update(phase_int8_kernels("cuda", peaks))
    report["headgrid"] = phase_headgrid("cuda", peaks)
    phase_int_mm("cuda", peaks)
    model = build_serving_model("cuda")
    launches = phase_serve(model, card, "cuda")
    model8 = EvalModel(model.backbone, model.lavila_cfg, model.decoder, model.dec_cfg, model.tokenizer,
                       input_res=model.input_res, device="cuda", int8=True)
    launches8 = phase_serve(model8, card, "cuda")
    phase_end_to_end(model, "cuda")
    phase_end_to_end_int8(model8, model, "cuda")
    del model, model8
    torch.cuda.empty_cache()
    long16, long8, launches_long = phase_serve_long(card)
    phase_end_to_end(long16, "cuda", phase="end-to-end-long")
    phase_end_to_end_int8(long8, long16, "cuda", phase="end-to-end-long-int8")
    counts = {
        "space": launches["divided_attention_space"], "time": launches["divided_attention_time"],
        "space_int8": launches8["divided_attention_space_int8"],
        "time_int8": launches8["divided_attention_time_int8"],
        "layer_norm_int8": launches8["layer_norm_int8"], "quick_gelu_int8": launches8["quick_gelu_int8"],
        "headgrid": launches_long["time_attention_headgrid"],
    }
    for key, n in counts.items():
        if n < 1:
            raise AssertionError(f"{report[key]['name']} was not launched on the main path")
        report[key]["launches"] = n
        report[key]["card"] = card
    print(json.dumps({"kernels": [report[k] for k in counts]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
