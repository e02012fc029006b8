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
   started together), with the build seconds and, a line a compiled
   kernel, ptxas's registers, spills and static shared memory.
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
   a yardstick (the port never calls it), with CUDA events, the kernel
   also by its device time in a ``torch.profiler`` trace (``ms``; the
   events' time through the wrapper is ``events_ms``), and prints the
   bf16 kernel's cut of the group (heads and warps a block, streamed or
   not, shared memory). K1 is also checked and timed at the long-clip
   shape (B=2, T=128), where it takes the largest share of the forward.
4. int8 kernels vs plain: K3 (the attention with its output quantized per
   token, both modes), K4 (LayerNorm -> int8, D=1024) and K5 (QuickGELU ->
   int8, D=4096) at (B=2, T=4) and the serving shape (B=8, T=16, N=256,
   32768 rows), inputs seeded N(0, 1), the LayerNorm gamma 1 + 0.2 N(0, 1)
   and beta 0.1 N(0, 1): scales within rtol 1e-5 of the plain version's,
   codes within 1, at most 0.1% of the codes changed. At the serving shape
   in bf16 each kernel (device time in a profiler trace, and CUDA events
   through the wrapper) and its plain version are timed, K4 and K5 beside
   the bytes they move and the share of their bound they reach. K4 prints
   its route (a warp a row, or a block a row) and is also checked at
   D=4096 (its block route) and D=1000 (a ragged warp row).
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
   dh=64, f32 and bf16, inputs seeded N(0, 1), against its plain version:
   the patch output with the tolerances of phase 3, the merged CLS output
   within 1e-4 in both types; at (B=1, T=128) and (B=2, T=128) in
   bf16 the kernel, the plain version and one SDPA call over [CLS | tube]
   are timed, beside the kernel's cut (persistent blocks, item slots).
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

12. train: the pretraining step (``train.make_train_step``) on the frozen
   full-width TimeSformer-L at 4 frames and the 13-query decoder with its
   22047-class head, seeded random weights; a fixed batch of 16 uint8 clips
   (one rank's share of the global 128 over 8 ranks), 5 captions a clip
   (some empty: padded rows), pixel boxes with some rows zero, 4 noun ids
   a clip with some padding, a seeded (582, 768) noun dictionary. Checks:
   the kernel wrappers refuse inputs that require grad; the same state and
   batch without dropout through the kernel route and the plain attention
   (f32: total loss within rtol 1e-4, the same hand, object and noun
   matches, each decoder gradient above rounding noise within cosine
   0.999, grad_norm within rtol 1e-3; bf16 kernel route vs f32 plain: total
   loss within rtol 5e-2, and the share of matches that differ); 8 steps
   at lr 1e-4 with dropout from a seeded generator: finite metrics, the
   last loss below the first, ``class_embed``, ``vid_proj`` and the backbone
   bit-identical, no backbone ``.grad``, K1 and K2 24 times a step and
   K3-K6 never (from the model's own ``_kernel_friendly``), the first step
   with CUDA sync warnings on (none may fire) and the rest under
   ``torch.cuda.set_sync_debug_mode("error")``. Then 2 warm-up and 10 timed
   steps (CUDA events): steps/s, clips/s, the split of a step (backbone
   forward; decoder, losses and backward; optimizer), peak memory and
   ``mfu_bf16``; and K1 and K2 alone at the train shape (B=16, T=4) as in
   phase 3.

Then one ``{"kernels": [...]}`` line, each kernel's launches summed over
phases 5, 6, 10 and 12, and, last, ``{"ok": true, "device":
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
import types
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
CLS_TOL = 1e-4  # K6's merged CLS output in both types: its partials keep f32 precision
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
# the kernels' names in a profiler trace: K1/K2 and K3's attention pass, the
# block-row pass of K3 and K5
ATTENTION_KERNEL, ROW_KERNEL = "attention_bf16_kernel", "row_int8_kernel"
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


def device_ms(fn, iters: int, kernels) -> float:
    """Mean device time in ms of the kernels whose names contain one of
    ``kernels`` (a string or a tuple of them) over ``iters`` calls of ``fn``,
    from a ``torch.profiler`` trace: the kernels alone. Back-to-back calls
    timed with events (``cuda_ms``) measure the host instead where the
    wrapper's host time exceeds a short kernel's (K4)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = (kernels,) if isinstance(kernels, str) else kernels
    hits = [e for e in prof.key_averages() if any(k in e.key for k in kernels)]
    us = sum(float(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total) for e in hits)
    if not us:
        raise RuntimeError(f"the trace shows no device time for a kernel named like {kernels!r}")
    return us / iters / 1e3


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


def _ptxas_report(log: str) -> list[dict]:
    """ptxas -v's lines, one entry a compiled kernel: its (demangled) name,
    registers a thread, spill stores and loads, static shared memory."""
    entries = []
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", ln):
            entries.append({"kernel": m.group(1)})
        elif entries and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            entries[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif entries and (m := re.search(r"Used (\d+) registers", ln)):
            smem = re.search(r"(\d+) bytes smem", ln)
            entries[-1].update(registers=int(m.group(1)), static_smem=int(smem.group(1)) if smem else 0)
    try:
        names = subprocess.run(["c++filt"], input="\n".join(e["kernel"] for e in entries),
                               capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) == len(entries):
        for e, nm in zip(entries, names):
            e["kernel"] = _strip_params(nm.replace("(anonymous namespace)::", "").removeprefix("void "))
    return entries


def _strip_params(name: str) -> str:
    """A demangled function name without its trailing parameter list."""
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i] if name.endswith(")") else name
    return name


def phase_build():
    from helping_hand_for_egocentric_videos_torch.ops import _build

    t0 = time.perf_counter()
    res = _build.build_all(verbose=True)
    for name, r in res.items():
        say("build", source=f"csrc/{name}.cu", seconds=round(r["seconds"], 3))
        for entry in _ptxas_report(r["log"]):
            say("build-ptxas", source=f"csrc/{name}.cu", **entry)
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


def _kernel_vs_plain(qkv, ck, cv, cq, mode):
    """The kernel against the plain version in f32 on the same inputs ->
    (the largest error of the patch output and the merged CLS output,
    whether both are finite, the plain patch output)."""
    import torch

    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    out, parts = da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=HEADS)
    cls = da.merge_cls_partials(*parts, cq, ck, cv, HEADS)
    f32 = [z.float() for z in (qkv, ck, cv, cq)]
    ref, ref_parts = da.divided_patch_attention_ref(*f32, mode=mode, heads=HEADS)
    ref_cls = da.merge_cls_partials(*ref_parts, *f32[3:], *f32[1:3], HEADS)
    torch.cuda.synchronize()
    err = max((out.float() - ref).abs().max().item(), (cls - ref_cls).abs().max().item())
    return err, bool(torch.isfinite(out).all()) and bool(torch.isfinite(cls).all()), ref


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
                err, finite, ref = _kernel_vs_plain(qkv, ck, cv, cq, mode)
                check = {"B": b, "T": t, "dtype": dname, "max_abs_err": err, "tolerance": TOL[dname]}
                say("kernel-vs-plain", mode=mode, **check)
                if not finite or not err <= TOL[dname]:
                    raise AssertionError(f"{mode} kernel disagrees with the plain version: {check}")
                checks.append(check)
        # timing at the serving shape in the serving type (the last inputs made)
        q, k, v = _sdpa_inputs(qkv, ck, cv, mode)
        lib_out = F.scaled_dot_product_attention(q, k, v)
        def run():
            return da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=HEADS)

        ms, events_ms = device_ms(run, 20, ATTENTION_KERNEL), cuda_ms(run, 20)
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
            "events_ms": events_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library_ms,
            "library_max_abs_err": (lib_as_out.float() - ref).abs().max().item(),
            "timed_at": {"B": b, "T": t, "N": N, "H": HEADS, "dh": DH, "dtype": "bfloat16"},
            "checks": checks,
        }
        say("kernel-timing", mode=mode, B=b, T=t, ms=ms, events_ms=events_ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by=bound_by, plan=_plan(N if mode == "space" else t))
        del qkv, ck, cv, cq, q, k, v, lib_out, ref
        torch.cuda.empty_cache()
    report["space"]["long_clip"] = _time_space_long(device, peaks, gen)
    return report


def _plan(w: int) -> dict:
    """The bf16 kernel's cut of a group of w rows at H=16, dh=64."""
    import ctypes

    from helping_hand_for_egocentric_videos_torch.ops._build import library

    fn = library("divided_attention").hh_divided_attention_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    plan = (ctypes.c_longlong * 4)()
    if fn(w, HEADS, DH, plan):
        raise RuntimeError(f"no plan for a group of {w} rows")
    return dict(zip(("heads_a_block", "warps_a_block", "streamed", "smem_bytes"), plan))


def _time_space_long(device, peaks, gen) -> dict:
    """K1 at the long-clip shape (B=2, T=128) in bf16, where it takes 40% of
    the busy time: checked against the plain version as above, then the
    kernel, the plain version and one SDPA call timed."""
    import torch
    import torch.nn.functional as F

    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    b, t = 2, LONG_T
    qkv = torch.randn(b, t, N, 3 * D, generator=gen, device=device).to(torch.bfloat16)
    ck, cv, cq = (torch.randn(b, D, generator=gen, device=device).to(torch.bfloat16) for _ in range(3))
    err, finite, _ = _kernel_vs_plain(qkv, ck, cv, cq, "space")
    if not finite or not err <= TOL["bfloat16"]:
        raise AssertionError(f"space kernel disagrees with the plain version at (B={b}, T={t}): {err}")
    q, k, v = _sdpa_inputs(qkv, ck, cv, "space")
    res = {
        "B": b, "T": t, "max_abs_err": err, "tolerance": TOL["bfloat16"],
        "ms": device_ms(lambda: da.divided_patch_attention(qkv, ck, cv, cq, mode="space", heads=HEADS), 20,
                        ATTENTION_KERNEL),
        "events_ms": cuda_ms(lambda: da.divided_patch_attention(qkv, ck, cv, cq, mode="space", heads=HEADS), 20),
        "plain_ms": cuda_ms(lambda: da.divided_patch_attention_ref(qkv, ck, cv, cq, mode="space", heads=HEADS), 5),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20),
    }
    res["bound_ms"], res["bound_by"] = _bound_ms(qkv, "space", peaks)
    say("kernel-timing", mode="space", **res)
    del qkv, ck, cv, cq, q, k, v
    torch.cuda.empty_cache()
    return res


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


def _rows_bytes(rows, d, in_bytes) -> int:
    """A per-row quantizing pass: read the rows once, write a code a value
    and a scale a row."""
    return rows * d * (in_bytes + 1) + rows * 4


def _rows_bound_ms(rows, d, in_bytes, ops_per_value, peaks) -> tuple[float, str]:
    """The pass's bytes over the memory rate, or its f32 arithmetic outside
    the tensor cores over their rate, whichever is larger."""
    by_bytes = _rows_bytes(rows, d, in_bytes) / peaks["bytes"]
    by_ops = rows * d * ops_per_value / peaks["float32"]
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def _ln_plan(x) -> dict:
    """K4's cut of the rows of x: its route and launch shape."""
    import ctypes

    import torch

    from helping_hand_for_egocentric_videos_torch.ops._build import library

    fn = library("act_quant").hh_layer_norm_int8_plan
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    plan = (ctypes.c_longlong * 4)()
    d = x.shape[-1]
    if fn(x.data_ptr(), x.numel() // d, d, int(x.dtype == torch.bfloat16), plan):
        raise RuntimeError(f"no K4 plan for rows of {d}")
    route = ("warp_row", "block_row")[plan[0]]
    return {"route": route, "values_a_lane": plan[1], "blocks": plan[2], "threads_a_block": plan[3]}


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

    def entry(name, source, replaces, last, timed, fn, plain, bound, kernels, nbytes=None, **extra):
        ms, events_ms, plain_ms = device_ms(fn, 20, kernels), cuda_ms(fn, 20), cuda_ms(plain, 5)
        bound_ms, bound_by = bound
        if nbytes is not None:  # the per-row passes: bytes moved and the share of the bound reached
            extra.update(bytes_moved=nbytes, achieved_tb_per_s=nbytes / (ms * 1e-3) / 1e12,
                         bound_share=bound_ms / ms)
        say("kernel-timing", kernel=name, ms=ms, events_ms=events_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, **extra)
        return {
            "name": name, "route": "cuda", "source": f"{REPO}/{source}", "replaces": replaces,
            "launches": None, "max_abs_err": last["max_abs_err"],
            "tolerance": "scales rtol 1e-5, codes within 1, <= 0.1% of codes changed",
            "codes_changed": last["codes_changed"], "ms": ms, "events_ms": events_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "timed_at": {**timed, "dtype": "bfloat16"}, **extra,
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
            _bound_ms(qkv, mode, peaks, quant_out=True), (ATTENTION_KERNEL, ROW_KERNEL),
        )
        del qkv, ck, cv, cq, got, want, parts, parts0
        torch.cuda.empty_cache()

    # K4 at D = 1024 and K5 at D = 4096, on B*T*N rows
    ln = nn.LayerNorm(D, device=device)
    with torch.no_grad():
        ln.weight.copy_(1.0 + 0.2 * torch.randn(D, generator=gen, device=device))
        ln.bias.copy_(0.1 * torch.randn(D, generator=gen, device=device))
    for name, d, ops, fn, plain, line, kernel in (
        ("layer_norm_int8", D, 14, lambda x: aq.layer_norm_int8(ln, x, 1e-6),
         lambda x: aq.layer_norm_int8_ref(ln, x, 1e-6), 45, "ln_int8_warp_kernel"),
        ("quick_gelu_int8", MLP, 12, aq.quick_gelu_int8, aq.quick_gelu_int8_ref, 57, ROW_KERNEL),
    ):
        for b, t in ROWS_SHAPES:
            for dtype in ((torch.float32, torch.bfloat16) if b * t < 64 else (torch.bfloat16,)):
                x = torch.randn(b * t * N, d, generator=gen, device=device).to(dtype)
                got, want = fn(x), plain(x)
                torch.cuda.synchronize()
                plan = {"plan": _ln_plan(x)} if name == "layer_norm_int8" else {}
                last = check(name, got, want, rows=x.shape[0], D=d, dtype=str(dtype).removeprefix("torch."),
                             **plan)
        rows = x.shape[0]
        report[name] = entry(
            name, "csrc/act_quant.cu", f"{TPU_ACT_QUANT}:{line}", last, {"rows": rows, "D": d},
            lambda: fn(x), lambda: plain(x), _rows_bound_ms(rows, d, x.element_size(), ops, peaks), kernel,
            nbytes=_rows_bytes(rows, d, x.element_size()), **plan,
        )
        del x, got, want
        torch.cuda.empty_cache()

    # K4 at two widths the model does not run, with the route each takes:
    # 4096 (above 2048: a block a row) and 1000 (a warp a row whose last
    # lanes hold fewer chunks)
    other_routes = []
    for d in (4 * D, 1000):
        wide = nn.LayerNorm(d, device=device)
        with torch.no_grad():
            wide.weight.copy_(1.0 + 0.2 * torch.randn(d, generator=gen, device=device))
            wide.bias.copy_(0.1 * torch.randn(d, generator=gen, device=device))
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(2 * 4 * N, d, generator=gen, device=device).to(dtype)
            got, want = aq.layer_norm_int8(wide, x, 1e-6), aq.layer_norm_int8_ref(wide, x, 1e-6)
            torch.cuda.synchronize()
            info = {"rows": x.shape[0], "D": d, "dtype": str(dtype).removeprefix("torch."), "plan": _ln_plan(x)}
            other_routes.append({**info, **check("layer_norm_int8", got, want, **info)})
    report["layer_norm_int8"]["other_routes"] = other_routes
    return report


def _headgrid_plan(t: int, items: int) -> dict:
    """K6's bf16 cut for T frames and B*N*H items at dh=64."""
    import ctypes

    from helping_hand_for_egocentric_videos_torch.ops._build import library

    fn = library("divided_attention_long").hh_time_attention_headgrid_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    plan = (ctypes.c_longlong * 5)()
    if fn(t, items, DH, plan):
        raise RuntimeError(f"no head-grid plan for T={t}")
    return dict(zip(("blocks", "warps_a_block", "item_slots", "smem_bytes", "blocks_an_sm"), plan))


def _time_headgrid(qkv, ck, cv, cq, ref, peaks) -> dict:
    """K6 (bf16), its plain version and one SDPA call over [CLS | tube] on
    the same inputs, with CUDA events; the bound and the kernel's cut."""
    import torch.nn.functional as F

    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    b, t = qkv.shape[:2]
    q, k, v = _sdpa_inputs(qkv, ck, cv, "time")
    lib_out = F.scaled_dot_product_attention(q, k, v)
    lib_as_out = lib_out.reshape(b, N, HEADS, t, DH).permute(0, 3, 1, 2, 4).reshape(b, t, N, D)
    res = {
        "B": b, "T": t,
        "ms": device_ms(lambda: da.divided_patch_attention(qkv, ck, cv, cq, mode="time", heads=HEADS), 20,
                        "headgrid_bf16_kernel"),
        "events_ms": cuda_ms(lambda: da.divided_patch_attention(qkv, ck, cv, cq, mode="time", heads=HEADS), 20),
        "plain_ms": cuda_ms(lambda: da.time_attention_headgrid_ref(qkv, ck, cv, cq, heads=HEADS), 5),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20),
        "library_max_abs_err": (lib_as_out.float() - ref).abs().max().item(),
    }
    res["bound_ms"], res["bound_by"] = _bound_ms(qkv, "time", peaks)
    res.update(bound_share=res["bound_ms"] / res["ms"], vs_library=res["ms"] / res["library_ms"],
               plan=_headgrid_plan(t, b * N * HEADS))
    say("kernel-timing", kernel="time_attention_headgrid", **res)
    return res


def phase_headgrid(device, peaks):
    """K6 against its plain version; timing at (B=1, T=128) and (B=2,
    T=128) in bf16."""
    import torch

    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    checks, timings = [], {}
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
            err = (out.float() - ref).abs().max().item()
            cls_err = (cls - ref_cls).abs().max().item()
            finite = bool(torch.isfinite(out).all()) and bool(torch.isfinite(cls).all())
            check = {"B": b, "T": t, "dtype": dname, "head_grid_by_default": da.needs_head_grid(t, N, HEADS),
                     "max_abs_err": err, "tolerance": TOL[dname], "cls_max_abs_err": cls_err,
                     "cls_tolerance": CLS_TOL}
            say("kernel-vs-plain", kernel="time_attention_headgrid", **check)
            if (not finite or not err <= TOL[dname] or not cls_err <= CLS_TOL
                    or tuple(parts[0].shape) != (b, N, HEADS, 1)):
                raise AssertionError(f"the head-grid kernel disagrees with its plain version: {check}")
            checks.append(check)
            del out, parts, ref_parts, f32
            if t == LONG_T and dtype == torch.bfloat16:
                timings[b] = _time_headgrid(qkv, ck, cv, cq, ref, peaks)
            del qkv, ck, cv, cq, ref
            torch.cuda.empty_cache()
    timed = timings[2]
    entry = {
        "name": "time_attention_headgrid", "route": "cuda",
        "source": f"{REPO}/csrc/divided_attention_long.cu", "replaces": TPU_HEADGRID,
        "launches": None, "tolerance": TOL["bfloat16"],
        "max_abs_err": next(c["max_abs_err"] for c in checks
                            if (c["B"], c["T"], c["dtype"]) == (2, LONG_T, "bfloat16")),
        **{k: timed[k] for k in ("ms", "events_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                 "library_max_abs_err", "plan")},
        "timed_at": {"B": 2, "T": LONG_T, "N": N, "H": HEADS, "dh": DH, "dtype": "bfloat16"},
        "at_B1": {k: timings[1][k] for k in ("ms", "events_ms", "plain_ms", "bound_ms", "library_ms", "plan")},
        "checks": checks,
    }
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


TRAIN_B, TRAIN_T, TRAIN_R = 16, 4, 5  # one rank's share of the global batch 128 over 8 ranks
TRAIN_NOUNS, TRAIN_VERBS, TRAIN_STEPS, TRAIN_LR = 582, 118, 8, 1e-4
TRAIN_WARM, TRAIN_TIMED = 2, 10
CAPTIONS = ("#C C cuts the onion on the board", "#C C opens the fridge", "#C C washes the knife in the sink",
            "#C C picks up a cup", "")  # the empty caption is a padded row


def build_train_inputs(device, backbone_name="timesformer_large", b=TRAIN_B, t=TRAIN_T, res=RES,
                       nouns=TRAIN_NOUNS, verbs=TRAIN_VERBS):
    """Seeded random full-width models (time attention N(0, 0.02)) and a
    fixed batch of b clips of t x res x res uint8 on ``device``: R captions
    a clip (some empty, so some rows are padding), pixel boxes with some
    zero rows, 4 noun ids a clip with some padding, and a seeded (nouns,
    768) noun dictionary. -> (lavila_cfg, backbone, dec_cfg, decoder,
    batch, noun_dict)."""
    import torch

    from helping_hand_for_egocentric_videos_torch.data import ClipTokenizer
    from helping_hand_for_egocentric_videos_torch.models import DecoderConfig, Lavila, ObjDecoder, lavila

    lcfg = getattr(lavila, f"{backbone_name}_config")(num_frames=t)
    dcfg = DecoderConfig(num_queries=13, feature_dim=lcfg.visual.width, text_width=lcfg.text.width, num_frames=t,
                         patches_per_frame=lcfg.visual.patches_per_frame, pred_traj=True)
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    backbone = Lavila(lcfg, generator=gen, device=device)
    decoder = ObjDecoder(dcfg, generator=gen, device=device)
    with torch.no_grad():  # as build_serving_model: a non-zero time attention
        for blk in backbone.visual.blocks:
            blk.timeattn.qkv.weight.normal_(0.0, 0.02, generator=gen)
            blk.timeattn.proj.weight.normal_(0.0, 0.02, generator=gen)
    rng = np.random.default_rng(SEED + 7)
    captions = [CAPTIONS[(i * 3 + i // TRAIN_R) % len(CAPTIONS)] for i in range(b * TRAIN_R)]
    boxes = np.concatenate([rng.random((b, t, 4, 2)) * 150, np.zeros((b, t, 4, 2))], -1)
    boxes[..., 2:] = boxes[..., :2] + 20 + rng.random((b, t, 4, 2)) * 60
    boxes[rng.random((b, t, 4)) < 0.25] = 0.0  # absent hands and objects
    noun_ids = rng.integers(1, nouns, size=(b, 4))
    noun_ids[rng.random((b, 4)) < 0.3] = 0  # padding nouns
    batch = {
        "video": rng.integers(0, 256, size=(b, t, res, res, 3), dtype=np.uint8),
        "tokens": ClipTokenizer()(captions).astype(np.int64),
        "noun_vec": (rng.random((b, nouns)) < 0.01).astype(np.float32),
        "verb_vec": (rng.random((b, verbs)) < 0.02).astype(np.float32),
        "boxes": boxes.astype(np.float32),
        "nouns": noun_ids,
    }
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    noun_dict = torch.randn(nouns, lcfg.text.width, generator=gen, device=device)
    return lcfg, backbone, dcfg, decoder, batch, noun_dict


def _train_matches(backbone, lcfg, decoder, dcfg, tcfg, batch, noun_dict) -> dict:
    """The step's three matchings (hands, objects, nouns) without dropout:
    target_to_pred of each, from the step's own functions."""
    import torch

    from helping_hand_for_egocentric_videos_torch.losses import compute_box_loss
    from helping_hand_for_egocentric_videos_torch.metrics import sim_matrix
    from helping_hand_for_egocentric_videos_torch.models.obj_decoder import decoder_forward, obj_proj, txt_proj
    from helping_hand_for_egocentric_videos_torch.ops.lap import solve_lap_batch
    from helping_hand_for_egocentric_videos_torch.ops.preprocess import resize_normalize
    from helping_hand_for_egocentric_videos_torch.train import backbone_features

    with torch.no_grad():
        video = resize_normalize(batch["video"], tcfg.input_res)
        grid, _ = backbone_features(backbone, lcfg, video, batch["tokens"], dtype=tcfg.backbone_dtype)
        out = decoder_forward(decoder, dcfg, grid.float())
        b, t = grid.shape[:2]
        kw = {"num_queries": tcfg.num_queries, "resize": tcfg.resize}
        hands = compute_box_loss("hand_boxes", out.pred_boxes, batch["boxes"][:, :, :2].reshape(b * t, 2, 4), **kw)
        objs = compute_box_loss("obj_boxes", out.pred_boxes, batch["boxes"][:, :, 2:].reshape(b * t, 2, 4), **kw)
        nouns = txt_proj(decoder, noun_dict)[batch["nouns"]]
        cost = (-sim_matrix(nouns, obj_proj(decoder, out.hs[-1])[:, :-1])).transpose(1, 2)
        t2p, _ = solve_lap_batch(cost, batch["nouns"] != 0)
    return {"hands": hands[1]["target_to_pred"], "objects": objs[1]["target_to_pred"], "nouns": t2p}


def _one_step(backbone, lcfg, decoder, dcfg, tcfg, batch, noun_dict, device):
    """One step without dropout from a copy of ``decoder`` -> (metrics,
    gradients by name, matches)."""
    import copy

    from helping_hand_for_egocentric_videos_torch.train import TrainState, make_train_step

    state = TrainState.create(copy.deepcopy(decoder), tcfg, device=device)
    matches = _train_matches(backbone, lcfg, state.decoder, dcfg, tcfg, batch, noun_dict)
    _, m = make_train_step(dcfg, lcfg, tcfg)(state, backbone, batch, noun_dict)
    grads = {n: p.grad for n, p in state.decoder.named_parameters() if p.grad is not None}
    return {k: float(v) for k, v in m.items()}, grads, matches


def _train_vs_plain(backbone, lcfg, decoder, dcfg, batch, noun_dict, device) -> dict:
    """The same state and batch, dropout off, through the kernel route and
    the plain attention: f32 against f32, bf16 against f32 plain."""
    import torch

    from helping_hand_for_egocentric_videos_torch.train import TrainConfig

    plain_cfg = replace(lcfg, visual=replace(lcfg.visual, attention_backend="reference"))
    f32 = TrainConfig(lr=TRAIN_LR, backbone_dtype=torch.float32)
    mk, gk, tk = _one_step(backbone, lcfg, decoder, dcfg, f32, batch, noun_dict, device)
    mp, gp, tp = _one_step(backbone, plain_cfg, decoder, dcfg, f32, batch, noun_dict, device)
    mb, _, tb = _one_step(backbone, lcfg, decoder, dcfg, replace(f32, backbone_dtype=torch.bfloat16), batch,
                          noun_dict, device)
    # the cosine of each gradient that rises above rounding noise; the key
    # biases' gradients are 0 in exact arithmetic (a softmax ignores a
    # constant added to a row of logits), so theirs is noise on both routes
    floor = 1e-6 * mp["grad_norm"]
    noise = sorted(n for n, g in gp.items() if float(g.norm()) <= floor)
    cos = {n: float(torch.nn.functional.cosine_similarity(g.flatten(), gp[n].flatten(), dim=0))
           for n, g in gk.items() if n not in noise}
    worst = min(cos, key=cos.get)
    same = {k: bool(torch.equal(tk[k], tp[k])) for k in tk}
    differ_bf16 = {k: float((tb[k] != tp[k]).float().mean()) for k in tk}
    res = {
        "f32_total_loss": {"kernel": mk["total_loss"], "plain": mp["total_loss"],
                           "rel_err": abs(mk["total_loss"] - mp["total_loss"]) / abs(mp["total_loss"]),
                           "rtol": 1e-4},
        "f32_matches_equal": same,
        "f32_grad_cosine_min": {"param": worst, "cosine": cos[worst], "limit": 0.999},
        "f32_grad_norm": {"kernel": mk["grad_norm"], "plain": mp["grad_norm"],
                          "rel_err": abs(mk["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"], "rtol": 1e-3},
        "bf16_total_loss": {"kernel": mb["total_loss"], "plain_f32": mp["total_loss"],
                            "rel_err": abs(mb["total_loss"] - mp["total_loss"]) / abs(mp["total_loss"]),
                            "rtol": 5e-2},
        "bf16_matches_differing_share": differ_bf16,
        "grads_compared": len(cos), "grads_at_rounding_noise": noise,
    }
    say("train-vs-plain", **res)
    if set(gk) != set(gp) or not all(np.isfinite(list(mk.values()))):
        raise AssertionError("the kernel route's step has other gradients than the plain route's")
    if not (res["f32_total_loss"]["rel_err"] <= 1e-4 and all(same.values()) and cos[worst] >= 0.999
            and res["f32_grad_norm"]["rel_err"] <= 1e-3 and res["bf16_total_loss"]["rel_err"] <= 5e-2):
        raise AssertionError(f"the train step's kernel route disagrees with its plain route: {res}")
    return res


def _sync_sites(fn) -> list[str]:
    """Run ``fn`` with CUDA sync warnings on -> where each sync was asked
    for: the innermost frames of the Python stack at each warning."""
    import traceback
    import warnings

    import torch

    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):  # not the mode's own notice
            frames = [f"{f.filename}:{f.lineno} {f.name}" for f in traceback.extract_stack()[:-1]]
            sites.append(" <- ".join(reversed(frames[-6:])))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sorted(set(sites))


def _train_guard(device) -> dict:
    """The kernel wrappers refuse inputs that require grad with grad mode on."""
    import torch

    from helping_hand_for_egocentric_videos_torch.ops import act_quant as aq
    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    qkv = torch.zeros(1, TRAIN_T, N, 3 * D, device=device, requires_grad=True)
    cls = [torch.zeros(1, D, device=device) for _ in range(3)]
    raised = {}
    for name, call in (("divided_patch_attention", lambda: da.divided_patch_attention(qkv, *cls, mode="space",
                                                                                       heads=HEADS)),
                       ("layer_norm_int8", lambda: aq.layer_norm_int8(torch.nn.LayerNorm(D, device=device),
                                                                      qkv[..., :D])),
                       ("quick_gelu_int8", lambda: aq.quick_gelu_int8(qkv[..., :D]))):
        try:
            call()
            raised[name] = False
        except RuntimeError as e:
            raised[name] = "no backward" in str(e)
    if not all(raised.values()):
        raise AssertionError(f"a kernel wrapper took an input that requires grad: {raised}")
    return raised


def _time_train_shape(device, peaks) -> dict:
    """K1 and K2 alone at the train shape (B=16, T=4) in bf16: checked
    against the plain version, then device time in a profiler trace, CUDA
    events, the plain version and one SDPA call, beside the bound."""
    import torch
    import torch.nn.functional as F

    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    out = {}
    for mode in ("space", "time"):
        qkv = torch.randn(TRAIN_B, TRAIN_T, N, 3 * D, generator=gen, device=device).to(torch.bfloat16)
        ck, cv, cq = (torch.randn(TRAIN_B, D, generator=gen, device=device).to(torch.bfloat16) for _ in range(3))
        err, finite, _ = _kernel_vs_plain(qkv, ck, cv, cq, mode)
        if not finite or not err <= TOL["bfloat16"]:
            raise AssertionError(f"{mode} kernel disagrees with the plain version at the train shape: {err}")
        q, k, v = _sdpa_inputs(qkv, ck, cv, mode)

        def run(qkv=qkv, ck=ck, cv=cv, cq=cq, mode=mode):
            return da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=HEADS)

        res = {"B": TRAIN_B, "T": TRAIN_T, "max_abs_err": err, "tolerance": TOL["bfloat16"],
               "ms": device_ms(run, 20, ATTENTION_KERNEL), "events_ms": cuda_ms(run, 20),
               "plain_ms": cuda_ms(lambda: da.divided_patch_attention_ref(qkv, ck, cv, cq, mode=mode, heads=HEADS), 5),
               "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)}
        res["bound_ms"], res["bound_by"] = _bound_ms(qkv, mode, peaks)
        say("kernel-timing", mode=mode, at="train", **res)
        out[mode] = res
        del qkv, ck, cv, cq, q, k, v
        torch.cuda.empty_cache()
    return out


def phase_train(card, peaks, device="cuda", backbone_name="timesformer_large", b=TRAIN_B):
    """The pretraining step at full width: kernel route vs plain route,
    8 steps with dropout (launch counts, frozen parameters, no host sync),
    then timing. -> (launches of the main path, K1/K2 at the train shape)."""
    import torch

    from helping_hand_for_egocentric_videos_torch.train import TrainConfig, TrainState, make_train_step
    from helping_hand_for_egocentric_videos_torch.train.step import backbone_features, pretrain_loss_and_metrics
    from helping_hand_for_egocentric_videos_torch.ops.preprocess import resize_normalize
    from helping_hand_for_egocentric_videos_torch.utils.flops import train_step_flops_per_clip

    t0 = time.perf_counter()
    lcfg, backbone, dcfg, decoder, batch, noun_dict = build_train_inputs(device, backbone_name, b)
    build_s = time.perf_counter() - t0
    guard = _train_guard(device)
    vs_plain = _train_vs_plain(backbone, lcfg, decoder, dcfg, batch, noun_dict, device)

    tcfg = TrainConfig(lr=TRAIN_LR)  # bf16 backbone, the default
    state = TrainState.create(decoder, tcfg, device=device)
    step = make_train_step(dcfg, lcfg, tcfg)
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    frozen = {k: v.clone() for k, v in decoder.state_dict().items() if k.split(".")[0] in ("class_embed", "vid_proj")}
    backbone_before = [p.detach().clone() for p in backbone.parameters()]
    # one step of the model's own route: K1 and K2 once a block at T=4
    per_step = launches_per_forward(types.SimpleNamespace(lavila_cfg=lcfg, int8=False))
    box, metrics = {"state": state}, []

    def one_step():
        box["state"], m = step(box["state"], backbone, batch, noun_dict, gen)
        metrics.append(m)
        counts.append(read_counts())

    # ---- the main path: counts set to 0 just before, read just after
    reset_counts()
    counts = []
    syncs = _sync_sites(one_step)  # the first step with sync warnings on: where it waits for the device
    if syncs:
        raise AssertionError(f"the train step waits for the device at {syncs}")
    torch.cuda.set_sync_debug_mode("error")  # any host sync inside steps 2-8 raises
    try:
        for _ in range(TRAIN_STEPS - 1):
            one_step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = read_counts()
    # ----
    state = box["state"]
    for i, c in enumerate(counts):
        if c != {k: v * (i + 1) for k, v in per_step.items()}:
            raise AssertionError(f"step {i + 1}: {c} launches, want {per_step} a step")
    losses = [float(m["total_loss"]) for m in metrics]
    finite = all(np.isfinite(float(v)) for m in metrics for v in m.values())
    frozen_same = all(torch.equal(v, state.decoder.state_dict()[k]) for k, v in frozen.items())
    backbone_same = all(torch.equal(a, p) for a, p in zip(backbone_before, backbone.parameters()))
    backbone_no_grad = all(p.grad is None for p in backbone.parameters())
    del backbone_before
    say("train-steps", card=card, steps=TRAIN_STEPS, lr=TRAIN_LR, total_loss=losses,
        last_metrics={k: float(v) for k, v in metrics[-1].items()}, launches_per_step=per_step,
        launches=launches, finite=finite, class_embed_vid_proj_unchanged=frozen_same,
        backbone_unchanged=backbone_same, backbone_without_grad=backbone_no_grad, host_syncs_in_step=syncs,
        sync_debug_mode="warn for step 1, error for steps 2-8", grad_guard_raised=guard, build_seconds=build_s)
    if not (finite and losses[-1] < losses[0] and frozen_same and backbone_same and backbone_no_grad):
        raise AssertionError("the train steps did not move as they must (see the train-steps line)")

    # ---- timing: 2 warm-up steps, then 10 timed with CUDA events
    for _ in range(TRAIN_WARM):
        state, _ = step(state, backbone, batch, noun_dict, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_TIMED):
        state, m = step(state, backbone, batch, noun_dict, gen)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / TRAIN_TIMED
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the step's three parts, each between CUDA events, over as many steps
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    split = np.zeros(3)
    for _ in range(TRAIN_TIMED):
        ev[0].record()
        video = resize_normalize(batch["video"], tcfg.input_res)
        grid, fmap = backbone_features(backbone, lcfg, video, batch["tokens"], dtype=tcfg.backbone_dtype)
        ev[1].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss, _ = pretrain_loss_and_metrics(state.decoder, dcfg, tcfg, grid.float(), fmap.float(), batch["tokens"],
                                            batch["noun_vec"], batch["verb_vec"], batch["boxes"], batch["nouns"],
                                            noun_dict, generator=gen)
        loss.backward()
        ev[2].record()
        state.optimizer.step()
        ev[3].record()
        ev[3].synchronize()
        split += [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    split /= TRAIN_TIMED
    flops = train_step_flops_per_clip(lcfg, dcfg, rephrase_factor=TRAIN_R)
    clips_per_s = b / (step_ms * 1e-3)
    timing = {
        "card": card, "B": b, "T": TRAIN_T, "step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
        "clips_per_s": clips_per_s, "split_ms": {"backbone_forward": split[0], "decoder_losses_backward": split[1],
                                                 "optimizer": split[2]},
        "tflop_per_clip": flops / 1e12, "mfu_bf16": flops * clips_per_s / peaks["bfloat16"],
        "peak_memory_gb": peak_gb, "timed_steps": TRAIN_TIMED, "warmup_steps": TRAIN_WARM,
    }
    say("train-timing", **timing)
    del state, backbone, decoder, batch, noun_dict, grid, fmap, video, loss
    torch.cuda.empty_cache()
    return launches, _time_train_shape(device, peaks), {"vs_plain": vs_plain, "timing": timing}


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
    del long16, long8
    torch.cuda.empty_cache()
    launches_train, train_shape, _ = phase_train(card, peaks)
    for mode in ("space", "time"):
        report[mode]["train_shape"] = train_shape[mode]
    # launches on the main path: the serving runs at 16 and at 128 frames, bf16
    # and int8, and the train steps
    total = {k: launches[k] + launches8[k] + launches_long[k] + launches_train[k] for k in _counters()}
    counts = {
        "space": total["divided_attention_space"], "time": total["divided_attention_time"],
        "space_int8": total["divided_attention_space_int8"], "time_int8": total["divided_attention_time_int8"],
        "layer_norm_int8": total["layer_norm_int8"], "quick_gelu_int8": total["quick_gelu_int8"],
        "headgrid": total["time_attention_headgrid"],
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
