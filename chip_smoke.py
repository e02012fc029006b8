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
   (B=2, T=4), the serving shape (B=8, T=16) and the eval harnesses'
   batches (20, 4), (10, 16) and (60, 16), N=256, H=16, dh=64, in
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
   shape (B=2, T=128), where it takes the largest share of the forward
   (K3 in space mode checked there too, at B=1 and 2, as in phase 4),
   and K1 and K2 at the local heads of TimeSformer-L split over 2 and 4
   ranks (H = 8 and 4) at (16, 4) and (8, 16), both types checked, bf16
   timed with the cut ``plan_bf16`` picks there ("local-heads" rows), and
   checked only at the model-axis loop's (32, 4) and its online EgoMCQ's
   (20, 4).
4. int8 kernels vs plain: K3 (the attention with its output quantized per
   token, both modes), K4 (LayerNorm -> int8, D=1024) and K5 (QuickGELU ->
   int8, D=4096) at (B=2, T=4) and the serving shape (B=8, T=16, N=256,
   32768 rows), inputs seeded N(0, 1), the LayerNorm gamma 1 + 0.2 N(0, 1)
   and beta 0.1 N(0, 1): scales within rtol 1e-5 of the plain version's,
   codes within 1, at most 0.1% of the codes changed; K3's CLS partials
   bit-equal to K1/K2's. At the serving shape in bf16 each kernel (device
   time in a profiler trace, and CUDA events through the wrapper) and its
   plain version are timed, K4 and K5 beside the bytes they move and the
   share of their bound they reach; K3 as its two launches a call (the
   attention pass and the row pass, ``row_int8_kernel``). K4 prints its
   route (a warp a row, or a block a row) and is also checked at D=4096 (its block
   route) and D=1000 (a ragged warp row). Then K1, K2 and K3 alone at the
   train step's shape (B=16, T=4) and the loop's (B=32, T=4), as at the
   serving shape (``_time_train_shapes``), and "profiler-check" (K1 and a
   ``torch.mm`` in one trace: the launches it holds of each, with and
   without idle margins around the window), repeated at the end of the run.
   Then, checked only, the batches of the benchmark's cells that no other
   check covers, in bf16 (``CELL_SHAPES``): K1, K2 and K3 at
   ``embed16.store_b64``'s (64, 16), K4 and K5 on its 262144 rows (past
   65535) and on ``pretrain4f.step_b16``'s 16384 (the int8 tower at those
   batches).
   Then ``torch._int_mm`` at the qkv shape (32768 x 1024 . 1024 x 3072),
   in both operand layouts, beside ``F.linear`` in bf16, as a line of its
   own (the port's int8 matmul is ``torch._int_mm``).
   Between K5 and the train shapes, the narrator's sampler kernel (K7,
   ``phase_sampler``) on seeded logits of GPT-2's scale at (640, 50257),
   peaked and flat, (640, 97), and Kimi-VL's (640, 163840) on its wide
   route, peaked and flat, T 0.7, top-p 0.95, each call's launch read back
   (the counter set to 0 just before): the kept sets
   parting from the plain version's only where a token's mass above lies
   within 1e-5 of top-p (sums in another order), 99.9% of the draws in the
   plain nucleus, 99% of the ids equal to the plain version's on the same
   seed, a 4-token row's frequencies at n = 20000 within 0.02; then its
   time (profiler and events) beside the plain version's, the sort route's
   the port had before it and the bytes' bound, and its registers and
   spills. ``python3 chip_smoke.py --sampler`` runs phases 1-2 and this
   alone.
   Then the narrator's decode attention (K8, ``phase_decode_attention``)
   at the benchmark's shapes in bf16, inputs seeded N(0, 1): the self mode
   at 640 sequences x 25 heads over 1, 33 and 77 of 77 cached positions,
   the query a strided view of ``c_attn``'s packed output as
   ``models/gpt2.py`` has it, and the cross mode at 64 clips x 10 rows
   over 256 latents, each through the route the decode step takes against
   its plain version (within one bf16 rounding, rtol 2^-7) and against f32
   SDPA (its relative gap no larger than bf16 SDPA's), the same bits twice,
   and the launch counts read back (both modes' counters set to 0 just
   before); then its time (profiler and events) beside the plain
   version's, SDPA's (``library_ms``, the call the decode step made before
   K8) and the bound of ``ops/bounds.decode_attention_bound_ms``, and each
   mode's cut and ptxas line. ``python3 chip_smoke.py --decode-attention``
   runs phases 1-2 and this alone.
   Then Kimi-VL's merged latent softmax (K9, ``phase_latent_softmax``) at
   its decode step's 10240 rows (64 clips x 10 sequences x 16 heads) over
   a prefix of 600 scores and a tail of 1, 33 and 77, scores seeded 20 N(0,
   1) at scale 1/sqrt(192): against its plain version (within one bf16
   rounding, rtol 2^-8 atol 1e-6), the same bits twice, the launches read
   back (the counter set to 0 just before); then its time (profiler and
   events) beside the plain version's, the library route's
   (``library_ms``: ``torch.softmax`` of one (rows, 600 + t) f32 buffer and
   the cast to bf16; ``library_cat_ms``: the same with the buffer made by
   ``torch.cat`` of the two) and the bound of
   ``ops/bounds.latent_softmax_bound_ms``. ``python3 chip_smoke.py
   --latent-softmax`` runs phases 1-2 and this alone.
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

12. eval checkpoints: seeded random weights at full width (TimeSformer-L
   and the 13-query decoder, 4 frames) written in the reference's layout
   under ``build/``, shared by phases 13-15. Each of those runs an eval
   CLI's ``main`` with the launch counts set to 0 just before and read
   just after (each video forward must launch what ``launches_per_forward``
   says: K1 and K2 24 times each in bf16; K3 24 + 24, K4 72, K5 24 with
   ``--int8``), checks its ``--out`` metrics (finite, in range) and its
   forwards, and prints the harness call's clips/s (its wall time, data
   decode included), the share of it spent waiting for a decoded item,
   and the peak memory. Then the same data goes through the harness
   function with an f32 kernel-route ``EvalModel`` and an f32
   ``attention_backend="reference"`` one on the CLI's weights: every
   similarity matrix the harness takes within 1e-3 absolute, and the
   CLI's bf16 embeddings against the f32 plain ones with a cosine of at
   least 0.99 a clip. ``HarnessProbe`` observes the runs without changing
   them.
13. eval-egomcq: ``cli.test_egomcq.main`` on ``write_egoclip_fixture``'s 40
   EgoMCQ items (4 frames, 5 clips an item, 4 items = 20 clips a forward).
14. eval-epic: ``cli.test_epic.main`` on a synthetic EPIC-100 layout (64
   clips of 0.5-2 s over three 256 x 456 ``.MP4.npy`` videos, a graded
   seeded relevancy matrix with a 1 in every row, a permuted
   ``indexes.pkl``, ``fps_dict_256.pth``) at 16 frames, ``--batch_size 8``,
   in bf16 and with ``--int8`` (int8 vs bf16 embeddings: cosine of at least
   ``INT8_COS_FLOOR`` a clip).
15. eval-egtea: ``cli.test_egtea.main`` on a synthetic EGTEA layout (106
   labels, 8 clips of 256 x 342 ``.mp4.npy`` frames, three shorter than 16
   x 2 so the dataset pads them), split 1, 10 clips of 16 frames at stride
   2, with ``--spatial_crops 1`` (10 clips a forward) and ``6`` (60: 15360
   time tubes, within the f32 route's grid); the f32 comparison on the
   6-crop model and the first two videos. Then "eval-tools":
   ``cli.extract_features.main`` over the EPIC videos (16-frame windows
   every 0.5 s) and ``cli.parity_check.main`` on the EPIC layout with
   ``--int8_diff`` and a target table of "eval-epic"'s bf16 metrics (each
   target must pass: the same weights and data give the same metrics).

16. train: the pretraining step (``train.make_train_step``) on the frozen
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
   ``mfu_bf16`` (K1 and K2 alone at this shape are timed after phase 4).

17. train-loop: ``cli.train.main``, the pretraining entry point, at the
   full width of phase 16 from seeded random weights, on a synthetic
   EgoClip layout the script writes under ``build/`` (two videos as
   chunked ``videos_256_chunked/<uid>/0.mp4.npy`` of 256 x 456 frames,
   192 narrations with hand-object detections, 40 EgoMCQ items, the
   582-noun taxonomy and a seeded (582, 768) noun dictionary, strict
   loading): ``--batch_size 16`` (32 clips a step with the scene-aware
   negatives), ``--augment`` with colour jitter, one epoch of 12 steps,
   online EgoMCQ and checkpoints every 6 steps (2 kept), metrics flushed
   every 6 steps, and ``--sync_debug error``: the steps that neither
   flush, evaluate nor save raise on any host sync. Then the same command
   resumed to step 16. Checks: the step counters, the logged steps after
   resume, every logged metric finite, the checkpoint directories (keep-k)
   and ``best/`` (the first eval that reached the highest Inter-video
   accuracy, if above 0), the backbone and ``class_embed`` / ``vid_proj``
   bit-identical to what the run built, and the launches: K1 and K2 24
   times a train step and an eval forward, K3-K6 never. It prints the
   steady window's steps/s, clips/s, step time, the share of it spent
   waiting for data, and peak memory.
18. train-loop-int8: the loop for 3 steps in bf16 (augmentation off), then
   with ``--int8_backbone``: K3 24 + 24, K4 72 and K5 24 launches a train
   step and an eval forward (the fused int8 route at T=4), K1/K2 never;
   the first step's loss within 5e-2 relative of the bf16 loop's.
19. train-loop-dist: the loop for 3 steps as one ``torchrun``-style rank
   (RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, MASTER_ADDR/PORT set by the
   script), so through ``nccl`` and the all-gather / all-reduce code: its
   losses within 1e-4 relative of the bf16 loop's of phase 18, the group
   destroyed at the end. (K1, K2 and K3 alone at the loop's shape (B=32,
   T=4) are timed after phase 4.)

20. visualize (right after "eval-tools", on phase 12's checkpoints):
   ``cli.visualize.main --attn`` at 4 frames on a synthetic 256 x 342
   ``.npy`` clip: ``boxes.png`` and ``cross_attn.png`` at their shapes,
   the boxes in [0, 224], the last decoder layer's cross-attention rows
   summing to 1 within 1e-3, K1 and K2 48 times each (the boxes' forward
   and the ``--attn`` forward, in bf16); the same frames' maps through the
   f32 kernel route and the f32 plain attention within 1e-4, and the CLI's
   bf16 maps against the f32 plain ones with a cosine of at least 0.99 a
   query.
21. profile: ``utils.profiling.top_ops`` on the trace of phase 17's traced
   step: device rows with names; the table printed; the trace holds the
   step's 24 + 24 attention launches (its window opens and closes on idle
   margins).
22. clip-bootstrap: a synthetic stock OpenAI ViT-L/14 at its published
   shapes (visual 1024 x 24, patch 14, 224 px, ``visual.proj`` (1024,
   768); text 768 x 12, vocabulary 49408, context 77), written with
   ``torch.save`` (1.7 GB), trains through ``cli.train.main
   --backbone_ckpt`` for 3 steps of 16 clips (8 items and their
   negatives): the TimeSformer bootstrapped from it, finite losses, K1 and
   K2 24 times a step and an eval forward, every K2 output of the first
   step exactly zero with finite CLS partials (its time attention starts
   at zero), the converted weights equal to the written ones, the frozen
   backbone unchanged.
23. clip-zoo: ``models.zoo.load_clip`` on that file and on a synthetic RN50
   at its published widths (layers (3, 4, 6, 3), width 64, output 1024,
   224 px; text 512 x 12): the configs read off as published;
   ``clip_preprocess`` of 32 uint8 frames of 256 x 342 on the card
   (against the CPU's, within 1e-4); the image and text towers on the card
   against the CPU in f32 within 1e-3 of the CPU's largest value; the
   card's images/s in f32 and bf16 at 32 images.
24. doctor: ``cli.doctor.main()`` on the card: usable, the card among its
   devices, every kernel library of ``csrc/`` in the build directory,
   rc 0.
25. train-tp (after "profile"): the mesh's model axis. ``nccl`` refuses two
   ranks on one card, so two ``gloo`` processes (this script with
   ``--tp-worker``) share it as one model group (model=2, data=1), each
   holding its half of the heads and hidden units of the full-width
   TimeSformer-L and CLIP text tower (``parallel.tensor.shard_lavila``)
   at phase 16's batch. The f32 step (TF32 off) against rank 0's
   one-process step: the backbone's outputs within 1e-5 of their largest
   value, loss terms within rtol 1e-4, gradients within 1e-4 x max(1,
   grad_norm), and within 1e-5 x max(1, grad_norm) with the object
   decoder's ReLU pattern of the one-process step imposed (a unit whose
   input lies within rounding of zero may change sign and turn its whole
   backward signal on or off; the line counts them, names the worst
   parameter, and shows the one-process step again and with the row-split
   sums made in halves), the updated parameters the same bits on both
   ranks; the bf16 kernel route's loss terms within rtol 1e-4 and
   gradients within cosine 0.999 of the one-process bf16 step's; K1 and K2
   24 times a step a rank, on 8 heads, every (mode, H, B, T) they launch
   at in this phase and the next held against the plain version in phase
   3; backend, step ms, each rank's peak memory beside the one-process
   step's. A collective that gloo refuses fails the phase with the rank's
   log.
26. train-loop-tp: ``cli.train.main --model_parallel 2`` on the same two
   ranks for 3 steps (``--num_workers 1``, the backbone in f32) against
   the same loop in one process: losses within rtol 1e-4; the online
   EgoMCQ, which both ranks run in bf16, with its similarities within 5e-3
   and the same picks but at near-ties.

Then one ``{"kernels": [...]}`` line, each tower kernel's launches summed
over phases 5, 6, 10, 12-20, 22, 25 and 26, then K7's, K8's and K9's
entries with their launches in their own phases, and, last, ``{"ok": true, "device":
{...}}``. Time
attention is zero-initialised in the model (its qkv feeds the kernel
zeros), so the smoke gives its weights seeded N(0, 0.02) values.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from functools import partial
from pathlib import Path

import numpy as np

from helping_hand_for_egocentric_videos_torch.ops.bounds import (
    attention_bound_ms,
    decode_attention_bound_ms,
    latent_softmax_bound_ms,
    rows_bound_ms,
    rows_bytes,
    sampler_bound_ms,
    sampler_bytes,
)
from helping_hand_for_egocentric_videos_torch.ops.counts import counters, read_counts, reset_counts
from helping_hand_for_egocentric_videos_torch.utils.profiling import (
    TRACE_MARGIN_S,
    cuda_ms,
    device_ms,
    kernel_events,
    named_kernels,
)

SEED = 0
N, HEADS, DH = 256, 16, 64
D = HEADS * DH
KERNEL_SHAPES = ((2, 4), (8, 16))  # (B, T); the last is the serving shape
# (B, T) of the eval harnesses' forwards beside (8, 16): EgoMCQ 4 items x 5 clips at 4 frames, EGTEA
# 10 windows of 16 frames, and 6 crops of them
EVAL_SHAPES = ((20, 4), (10, 16), (60, 16))
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


def say(phase: str, **kw):
    print(f"[{phase}] " + json.dumps(kw), flush=True)


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
    ptxas = {}
    for name, r in res.items():
        say("build", source=f"csrc/{name}.cu", seconds=round(r["seconds"], 3))
        ptxas[name] = _ptxas_report(r["log"])
        for entry in ptxas[name]:
            say("build-ptxas", source=f"csrc/{name}.cu", **entry)
    say("build", total_seconds=round(time.perf_counter() - t0, 3))
    return ptxas


def _sdpa_inputs(qkv, ck, cv, mode, heads=HEADS):
    """Head-major q and [CLS | group] k, v for F.scaled_dot_product_attention."""
    import torch

    b, t, n, _ = qkv.shape
    q, k, v = qkv.reshape(b, t, n, 3, heads, DH).unbind(3)
    perm, g, w = ((0, 1, 3, 2, 4), t, n) if mode == "space" else ((0, 2, 3, 1, 4), n, t)

    def grp(z):
        return z.permute(*perm).reshape(b * g, heads, w, DH)

    def with_cls(c, z):
        c = c.reshape(b, 1, heads, 1, DH).expand(b, g, heads, 1, DH).reshape(b * g, heads, 1, DH)
        return torch.cat([c, grp(z)], dim=2).contiguous()

    return grp(q).contiguous(), with_cls(ck, k), with_cls(cv, v)


def _kernel_vs_plain(qkv, ck, cv, cq, mode, heads=HEADS):
    """The kernel against the plain version in f32 on the same inputs ->
    (the largest error of the patch output and the merged CLS output,
    whether both are finite, the plain patch output)."""
    import torch

    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    out, parts = da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=heads)
    cls = da.merge_cls_partials(*parts, cq, ck, cv, heads)
    f32 = [z.float() for z in (qkv, ck, cv, cq)]
    ref, ref_parts = da.divided_patch_attention_ref(*f32, mode=mode, heads=heads)
    ref_cls = da.merge_cls_partials(*ref_parts, *f32[3:], *f32[1:3], heads)
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
        b, t = qkv.shape[:2]
        bound_ms, bound_by = attention_bound_ms(b, t, N, HEADS, DH, "bfloat16", mode, peaks)
        perm = (0, 1, 3, 2, 4) if mode == "space" else (0, 3, 1, 2, 4)
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
            bound_ms=bound_ms, bound_by=bound_by, plan=da.plan(N if mode == "space" else t, HEADS, DH))
        del qkv, ck, cv, cq, q, k, v, lib_out, ref
        torch.cuda.empty_cache()
        for b, t in EVAL_SHAPES:  # checked only: the eval harnesses' batches
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).removeprefix("torch.")
                qkv = torch.randn(b, t, N, 3 * D, generator=gen, device=device).to(dtype)
                ck, cv, cq = (torch.randn(b, D, generator=gen, device=device).to(dtype) for _ in range(3))
                err, finite, _ = _kernel_vs_plain(qkv, ck, cv, cq, mode)
                check = {"B": b, "T": t, "dtype": dname, "max_abs_err": err, "tolerance": TOL[dname], "at": "eval"}
                say("kernel-vs-plain", mode=mode, **check)
                if not finite or not err <= TOL[dname]:
                    raise AssertionError(f"{mode} kernel disagrees with the plain version: {check}")
                report[mode]["checks"].append(check)
                del qkv, ck, cv, cq
                torch.cuda.empty_cache()
    report["space"]["long_clip"] = _time_space_long(device, peaks, gen)
    return report


def _time_space_long(device, peaks, gen) -> dict:
    """K1 at the long-clip shape (B=2, T=128) in bf16, where it takes 40% of
    the busy time: checked against the plain version as above, then the
    kernel, the plain version and one SDPA call timed. Before it, K3 in
    space mode at the long int8 path's (1, 128) and (2, 128): codes and
    scales against the plain version, CLS partials bit-equal to K1's."""
    import torch
    import torch.nn.functional as F

    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    for b in (1, 2):
        qkv = torch.randn(b, LONG_T, N, 3 * D, generator=gen, device=device).to(torch.bfloat16)
        ck, cv, cq = (torch.randn(b, D, generator=gen, device=device).to(torch.bfloat16) for _ in range(3))
        got, parts = da.divided_patch_attention(qkv, ck, cv, cq, mode="space", heads=HEADS, quant_out=True)
        _, parts0 = da.divided_patch_attention(qkv, ck, cv, cq, mode="space", heads=HEADS)
        want, _ = da.divided_patch_attention_ref(qkv, ck, cv, cq, mode="space", heads=HEADS, quant_out=True)
        res = {**_quant_check(got, want), "partials_as_without_quant": all(map(torch.equal, parts, parts0))}
        say("kernel-vs-plain", kernel="divided_attention_space_int8", B=b, T=LONG_T, dtype="bfloat16", **res)
        if not res["ok"] or not res["partials_as_without_quant"]:
            raise AssertionError(f"K3 space at (B={b}, T={LONG_T}) disagrees with its plain version or K1: {res}")
        del qkv, ck, cv, cq, got, want, parts, parts0
        torch.cuda.empty_cache()

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
    res["bound_ms"], res["bound_by"] = attention_bound_ms(b, t, N, HEADS, DH, "bfloat16", "space", peaks)
    say("kernel-timing", mode="space", **res)
    del qkv, ck, cv, cq, q, k, v
    torch.cuda.empty_cache()
    return res


# K1/K2 on the local heads of TimeSformer-L split over 2 and 4 ranks (the
# model axis): (B, T) of the train step and of serving, timed
LOCAL_HEADS, LOCAL_SHAPES = (8, 4), ((16, 4), (8, 16))


def _tp_loop_shapes() -> tuple:
    """(B, T) that "train-loop-tp" gives K1/K2 on each rank, checked only:
    the loop's 32 clips (f32, ``TP_LOOP_SET``) and its online EgoMCQ's
    forwards of 20 (bf16)."""
    return (2 * LOOP_ITEMS, LOOP_T), (5 * LOOP_EVAL_ITEMS_PER_FORWARD, LOOP_T)


def _local_vs_plain(b, t, heads, mode, gen, device):
    """K1 or K2 at ``heads`` heads against the plain version in f32 and in
    bf16 on fresh inputs, raising where they disagree -> (errors by type,
    the bf16 inputs)."""
    import torch

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        qkv = torch.randn(b, t, N, 3 * heads * DH, generator=gen, device=device).to(dtype)
        ck, cv, cq = (torch.randn(b, heads * DH, generator=gen, device=device).to(dtype) for _ in range(3))
        err, finite, _ = _kernel_vs_plain(qkv, ck, cv, cq, mode, heads)
        errs[dname] = err
        if not finite or not err <= TOL[dname]:
            raise AssertionError(f"{mode} kernel at {heads} heads, (B, T) = ({b}, {t}), {dname}, "
                                 f"disagrees with the plain version: {err}")
    return errs, (qkv, ck, cv, cq)


def _time_local_heads(device, peaks) -> list[dict]:
    """"kernel-timing" at local heads: K1 and K2 at H = 8 and 4 (dh 64, N
    256), (16, 4) and (8, 16), in bf16: checked against the plain version
    (and in f32), then the kernel's device time, CUDA events, the plain
    version, one SDPA call and the bound, beside the cut of the group that
    ``plan_bf16`` picks at that head count. Then checked only, in both
    types, at ``_tp_loop_shapes``: every (B, T, H) of the model-axis
    phases is held against the plain version ("train-tp" asserts it from
    the shapes its ranks launched)."""
    import torch
    import torch.nn.functional as F

    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    rows = []
    for heads in LOCAL_HEADS:
        for b, t in _tp_loop_shapes():
            for mode in ("space", "time"):
                errs, _ = _local_vs_plain(b, t, heads, mode, gen, device)
                row = {"mode": mode, "H": heads, "B": b, "T": t, "max_abs_err": errs["bfloat16"],
                       "max_abs_err_f32": errs["float32"], "tolerance": TOL["bfloat16"],
                       "tolerance_f32": TOL["float32"], "at": "train-loop-tp"}
                say("kernel-vs-plain", **row)
                rows.append(row)
                torch.cuda.empty_cache()
        for b, t in LOCAL_SHAPES:
            for mode in ("space", "time"):
                errs, (qkv, ck, cv, cq) = _local_vs_plain(b, t, heads, mode, gen, device)
                q, k, v = _sdpa_inputs(qkv, ck, cv, mode, heads)

                def run(qkv=qkv, ck=ck, cv=cv, cq=cq, mode=mode, heads=heads):
                    return da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=heads)

                res = {"mode": mode, "H": heads, "B": b, "T": t, "max_abs_err": errs["bfloat16"],
                       "max_abs_err_f32": errs["float32"], "tolerance": TOL["bfloat16"],
                       "ms": device_ms(run, 20, ATTENTION_KERNEL), "events_ms": cuda_ms(run, 20),
                       "plain_ms": cuda_ms(lambda: da.divided_patch_attention_ref(qkv, ck, cv, cq, mode=mode,
                                                                                  heads=heads), 5),
                       "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20),
                       "plan": da.plan(N if mode == "space" else t, heads, DH)}
                res["bound_ms"], res["bound_by"] = attention_bound_ms(b, t, N, heads, DH, "bfloat16", mode, peaks)
                say("kernel-timing", at="local-heads", **res)
                rows.append(res)
                del qkv, ck, cv, cq, q, k, v
                torch.cuda.empty_cache()
    return rows


def _time_train_shapes(device, peaks) -> dict:
    """K1, K2 and K3 (both modes) alone at the train step's shape (B=16,
    T=4) and the loop's (B=32 clips, T=4), in bf16: checked against their
    plain versions, then device time in a profiler trace (K3's two
    launches), CUDA events, the plain version, one SDPA call (K1, K2) and
    the bound. Called right after phase 4 (``device_ms`` refuses a trace
    that lacks a launch). K4 and K5 see 32 x 4 x 256 = 32768 rows in the
    loop, the rows of phase 4's timing."""
    import torch
    import torch.nn.functional as F

    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    out = {}
    for b, t, at, seed in ((TRAIN_B, TRAIN_T, "train", SEED + 9), (2 * LOOP_ITEMS, LOOP_T, "train-loop", SEED + 13)):
        gen = torch.Generator(device=device).manual_seed(seed)
        for mode in ("space", "time"):
            qkv = torch.randn(b, t, N, 3 * D, generator=gen, device=device).to(torch.bfloat16)
            ck, cv, cq = (torch.randn(b, D, generator=gen, device=device).to(torch.bfloat16) for _ in range(3))
            err, finite, _ = _kernel_vs_plain(qkv, ck, cv, cq, mode)
            got, _ = da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=HEADS, quant_out=True)
            want, _ = da.divided_patch_attention_ref(qkv, ck, cv, cq, mode=mode, heads=HEADS, quant_out=True)
            qres = _quant_check(got, want)
            if not finite or not err <= TOL["bfloat16"] or not qres["ok"]:
                raise AssertionError(f"{mode} kernels disagree with their plain versions at the {at} shape: "
                                     f"{err} {qres}")
            q, k, v = _sdpa_inputs(qkv, ck, cv, mode)
            for quant in (False, True):
                def run(qkv=qkv, ck=ck, cv=cv, cq=cq, mode=mode, quant=quant):
                    return da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=HEADS, quant_out=quant)

                def plain(qkv=qkv, ck=ck, cv=cv, cq=cq, mode=mode, quant=quant):
                    return da.divided_patch_attention_ref(qkv, ck, cv, cq, mode=mode, heads=HEADS,
                                                          quant_out=quant)

                res = {"B": b, "T": t, "max_abs_err": qres["max_abs_err"] if quant else err,
                       "ms": device_ms(run, 20, (ATTENTION_KERNEL, ROW_KERNEL) if quant else ATTENTION_KERNEL,
                                       2 if quant else 1),
                       "events_ms": cuda_ms(run, 20), "plain_ms": cuda_ms(plain, 5),
                       "library_ms": None if quant else cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)}
                res["bound_ms"], res["bound_by"] = attention_bound_ms(b, t, N, HEADS, DH, "bfloat16", mode, peaks,
                                                                      quant_out=quant)
                key = f"{mode}_int8" if quant else mode
                say("kernel-timing", mode=key, at=at, **res)
                out.setdefault(key, {})[at] = res
            del qkv, ck, cv, cq, q, k, v, got, want
            torch.cuda.empty_cache()
    return out


# (B, T) of the benchmark's cells (BENCHMARK.json) that no other check covers:
# embed16.store_b64's batch for K1-K3, and the B*T*N rows of that batch (past
# 65535) and of pretrain4f.step_b16's for K4/K5, which the int8 tower runs
CELL_SHAPES = {"embed16.store_b64": (64, 16), "pretrain4f.step_b16": (16, 4)}


def _check_cell_shapes(device) -> list[dict]:
    """The kernels against their plain versions at ``CELL_SHAPES`` in bf16
    (the cells' type), with phase 3's and phase 4's tolerances."""
    import torch
    from torch import nn

    from helping_hand_for_egocentric_videos_torch.ops import act_quant as aq
    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    checks = []
    cell = "embed16.store_b64"
    b, t = CELL_SHAPES[cell]
    for mode in ("space", "time"):
        qkv = torch.randn(b, t, N, 3 * D, generator=gen, device=device).to(torch.bfloat16)
        ck, cv, cq = (torch.randn(b, D, generator=gen, device=device).to(torch.bfloat16) for _ in range(3))
        err, finite, _ = _kernel_vs_plain(qkv, ck, cv, cq, mode)
        check = {"kernel": f"divided_attention_{mode}", "B": b, "T": t, "dtype": "bfloat16", "max_abs_err": err,
                 "tolerance": TOL["bfloat16"], "at": cell}
        say("kernel-vs-plain", **check)
        if not finite or not err <= TOL["bfloat16"]:
            raise AssertionError(f"{mode} kernel disagrees with the plain version: {check}")
        checks.append(check)
        got, parts = da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=HEADS, quant_out=True)
        _, parts0 = da.divided_patch_attention(qkv, ck, cv, cq, mode=mode, heads=HEADS)
        want, _ = da.divided_patch_attention_ref(qkv, ck, cv, cq, mode=mode, heads=HEADS, quant_out=True)
        torch.cuda.synchronize()
        res = {"kernel": f"divided_attention_{mode}_int8", "B": b, "T": t, "dtype": "bfloat16", "at": cell,
               "partials_as_without_quant": all(torch.equal(x, y) for x, y in zip(parts, parts0)),
               **_quant_check(got, want)}
        say("kernel-vs-plain", **res)
        if not (res["ok"] and res["partials_as_without_quant"]):
            raise AssertionError(f"K3 {mode} disagrees with its plain version or K1/K2's partials: {res}")
        checks.append(res)
        del qkv, ck, cv, cq, got, want, parts, parts0
        torch.cuda.empty_cache()

    ln = nn.LayerNorm(D, device=device)
    with torch.no_grad():
        ln.weight.copy_(1.0 + 0.2 * torch.randn(D, generator=gen, device=device))
        ln.bias.copy_(0.1 * torch.randn(D, generator=gen, device=device))
    for name, d, fn, plain in (
        ("layer_norm_int8", D, lambda x: aq.layer_norm_int8(ln, x, 1e-6),
         lambda x: aq.layer_norm_int8_ref(ln, x, 1e-6)),
        ("quick_gelu_int8", MLP, aq.quick_gelu_int8, aq.quick_gelu_int8_ref),
    ):
        for cell, (b, t) in CELL_SHAPES.items():
            x = torch.randn(b * t * N, d, generator=gen, device=device).to(torch.bfloat16)
            got, want = fn(x), plain(x)
            torch.cuda.synchronize()
            res = {"kernel": name, "rows": x.shape[0], "D": d, "dtype": "bfloat16", "at": cell,
                   **_quant_check(got, want)}
            say("kernel-vs-plain", **res)
            if not res["ok"]:
                raise AssertionError(f"{name} disagrees with its plain version: {res}")
            checks.append(res)
            del x, got, want
            torch.cuda.empty_cache()
    return checks


def phase_profiler_check(at: str) -> dict:
    """"profiler-check": K1 at the train shape (16, 4) and one bf16
    ``torch.mm`` a call, 20 calls in a ``torch.profiler`` trace of the
    device: the launches of each that the trace holds, in a window with no
    idle host time around the calls and in one with ``TRACE_MARGIN_S`` of it
    on each side (``device_ms``'s), each opened by ``kernel_events``'
    sentinel launches, which it leaves out. Run after phase 4 and again at the
    end of the run, where traces without margins lost kernel events. The
    ``torch.mm`` launches (through PyTorch's runtime) tell whether the trace
    loses every kernel or only those of this repository's libraries (their
    own static CUDA runtime, loaded with ctypes); the margins, whether it
    drops events that its clock places outside the window."""
    import torch

    from helping_hand_for_egocentric_videos_torch.ops import divided_attention as da

    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    qkv = torch.randn(TRAIN_B, TRAIN_T, N, 3 * D, generator=gen, device="cuda").to(torch.bfloat16)
    ck, cv, cq = (torch.randn(TRAIN_B, D, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    a = torch.randn(1024, 1024, generator=gen, device="cuda").to(torch.bfloat16)

    def call():
        da.divided_patch_attention(qkv, ck, cv, cq, mode="space", heads=HEADS)
        torch.mm(a, a)

    iters = 20
    res = {"at": at, "calls": iters}
    for margin in (0.0, TRACE_MARGIN_S):
        events = kernel_events(call, iters, margin)
        launches, us = named_kernels(events, ATTENTION_KERNEL)
        other = sum(e.count for e in events if ATTENTION_KERNEL not in e.key
                    and e.device_type == torch.autograd.DeviceType.CUDA)
        res[f"margin_{margin}_s"] = {"attention_launches_in_trace": launches, "other_kernels_in_trace": other,
                                     "attention_device_ms": us / iters / 1e3 if launches else None}
    res["attention_events_ms"] = cuda_ms(lambda: da.divided_patch_attention(qkv, ck, cv, cq, mode="space",
                                                                            heads=HEADS), iters)
    say("profiler-check", **res)
    del qkv, ck, cv, cq, a
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

    def entry(name, source, replaces, last, timed, fn, plain, bound, kernels, nbytes=None, per_call=1, **extra):
        ms, events_ms, plain_ms = device_ms(fn, 20, kernels, per_call), cuda_ms(fn, 20), cuda_ms(plain, 5)
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
            attention_bound_ms(b, t, N, HEADS, DH, "bfloat16", mode, peaks, quant_out=True),
            (ATTENTION_KERNEL, ROW_KERNEL), per_call=2,
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
                plan = {"plan": aq.layer_norm_plan(x)} if name == "layer_norm_int8" else {}
                last = check(name, got, want, rows=x.shape[0], D=d, dtype=str(dtype).removeprefix("torch."),
                             **plan)
        rows = x.shape[0]
        report[name] = entry(
            name, "csrc/act_quant.cu", f"{TPU_ACT_QUANT}:{line}", last, {"rows": rows, "D": d},
            lambda: fn(x), lambda: plain(x), rows_bound_ms(rows, d, x.element_size(), ops, peaks), kernel,
            nbytes=rows_bytes(rows, d, x.element_size()), **plan,
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
            info = {"rows": x.shape[0], "D": d, "dtype": str(dtype).removeprefix("torch."),
                    "plan": aq.layer_norm_plan(x)}
            other_routes.append({**info, **check("layer_norm_int8", got, want, **info)})
    report["layer_norm_int8"]["other_routes"] = other_routes
    return report


# (rows, V, logits): the narrator's 64 clips x 10 sequences over GPT-2's vocabulary, peaked as a trained
# model's or flat as the benchmark's seeded one's (a nucleus of tens of thousands); the tiny vocabulary;
# Kimi-VL's 163840 words, on the kernel's wide route
SAMPLER_SHAPES = ((640, 50257, "peaked"), (640, 50257, "flat"), (640, 97, "peaked"), (640, 163840, "peaked"),
                  (640, 163840, "flat"))
SAMPLER_KERNEL = "nucleus_sample_kernel"


def sampler_logits(rows: int, v: int, kind: str, gen, device):
    """Seeded logits of GPT-2's scale: "peaked", a bulk near -100 with a
    spread of 3 under a head of 1-64 tokens a row raised by 5-20; "flat",
    N(0, 1)."""
    import torch

    if kind == "flat":
        return torch.randn(rows, v, generator=gen, device=device)
    x = -100.0 + 3.0 * torch.randn(rows, v, generator=gen, device=device)
    k = torch.randint(1, 65, (rows, 1), generator=gen, device=device)
    head = torch.rand(rows, v, generator=gen, device=device).argsort(dim=-1) < k
    return x + head * (5.0 + 15.0 * torch.rand(rows, v, generator=gen, device=device))


def _mass_above(scores):
    """Each score's softmax mass of the scores strictly greater, in float64:
    two kept sets may part only where it lies at top_p within rounding."""
    import torch

    s = scores.double()
    p = (s - s.amax(-1, keepdim=True)).exp()
    p = p / p.sum(-1, keepdim=True)
    sv, order = torch.sort(s, dim=-1, descending=True)
    ps = p.gather(1, order)
    cum = ps.cumsum(-1) - ps
    new = torch.cat([torch.ones_like(sv[:, :1], dtype=torch.bool), sv[:, 1:] != sv[:, :-1]], 1)
    first = torch.where(new, torch.arange(sv.shape[1]).expand_as(sv), 0).cummax(-1).values
    return torch.empty_like(cum).scatter_(1, order, cum.gather(1, first))


def _parent_sample_next(logits, temperature, top_p, generator):
    """The sort route the port had before the kernel: ``nucleus_mask``, a
    second softmax and ``argmax(p / E)``."""
    import torch

    from helping_hand_for_egocentric_videos_torch.ops import sampling

    scores, drop = sampling.nucleus_mask(logits, temperature, top_p)
    probs = scores.masked_fill(drop, float("-inf")).softmax(dim=-1)
    race = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return (probs / race).argmax(dim=-1)


def phase_sampler(device, peaks, ptxas=None) -> dict:
    """The narrators' sampler kernel (K7) against its plain version: the
    kept set (each row's edge), the draws on one seed, the call's launch,
    the 4-token frequencies at n = 20000; then its time at each of
    ``SAMPLER_SHAPES`` beside the plain version's, the sort route's and the
    bytes' bound."""
    import torch

    from helping_hand_for_egocentric_videos_torch.ops import sampling

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    temperature, top_p = 0.7, 0.95
    report = {}
    for rows, v, kind in SAMPLER_SHAPES:
        logits = sampler_logits(rows, v, kind, gen, device)
        seed = torch.randint(-(2 ** 63), 2 ** 63 - 1, (1,), generator=gen, device=device)
        thr = torch.empty(rows, device=device)
        sampling.nucleus_sample.launches = 0
        ids = sampling.nucleus_sample(logits, temperature, top_p, seed, threshold=thr)
        launched = sampling.nucleus_sample.launches
        torch.cuda.synchronize()
        cpu = logits.cpu()
        scores, edge = sampling.nucleus_threshold_ref(cpu, temperature, top_p)
        keep, want = scores >= thr.cpu()[:, None], scores >= edge[:, None]
        ids, want_ids = ids.cpu(), sampling.sample_next_ref(cpu, temperature, top_p, int(seed))
        r, differ = torch.arange(rows), keep != want
        res = {"rows": rows, "V": v, "logits": kind, "route": sampling.route(v), "launches": launched,
               "edges_equal": float((thr.cpu() == edge).float().mean()),
               "kept_differ": int(differ.sum()), "nucleus_median": float(want.sum(-1).median()),
               "kept_differ_off_edge": int(((_mass_above(scores)[differ] - top_p).abs() >= 1e-5).sum()),
               "ids_in_plain_nucleus": float(want[r, ids].float().mean()),
               "ids_equal_plain": float((ids == want_ids).float().mean())}
        res["ok"] = (launched == 1 and res["kept_differ_off_edge"] == 0 and res["ids_in_plain_nucleus"] >= 0.999
                     and res["ids_equal_plain"] >= 0.99)
        say("kernel-vs-plain", kernel="nucleus_sample", **res)
        if not res["ok"]:
            raise AssertionError(f"the sampler kernel disagrees with its plain version: {res}")
        fn = partial(sampling.nucleus_sample, logits, temperature, top_p, seed)
        events_ms = cuda_ms(fn, 20)
        try:  # the kernel alone; a trace that lost a launch's event reads nothing
            ms = device_ms(fn, 20, SAMPLER_KERNEL)
        except RuntimeError as err:
            say("kernel-timing", kernel="nucleus_sample", trace=str(err))
            ms = events_ms
        plain_ms = cuda_ms(partial(sampling.sample_next_ref, logits, temperature, top_p, 5), 3)
        sort_ms = cuda_ms(partial(_parent_sample_next, logits, temperature, top_p, gen), 5)
        nbytes = sampler_bytes(rows, v)
        bound_ms, bound_by = sampler_bound_ms(rows, v, peaks)
        timing = {"rows": rows, "V": v, "logits": kind, "ms": ms, "events_ms": events_ms, "plain_ms": plain_ms,
                  "sort_route_ms": sort_ms, "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
                  "achieved_tb_per_s": nbytes / (ms * 1e-3) / 1e12}
        say("kernel-timing", kernel="nucleus_sample", **timing)
        report[f"{kind}_V{v}"] = {**res, **timing}
        del logits, cpu, scores, keep, want
    # the distribution: a 4-token row at n = 20000 (top_p 0.9 keeps three)
    n = 20000
    batch = torch.log(torch.tensor([[0.5, 0.3, 0.15, 0.05]], device=device)).expand(n, -1).contiguous()
    got = sampling.sample_next(batch, 1.0, 0.9, torch.Generator(device=device).manual_seed(8)).cpu()
    freq = torch.bincount(got, minlength=4).double() / n
    want = torch.tensor([0.5, 0.3, 0.15, 0.0], dtype=torch.float64) / 0.95
    dist = {"freq": [round(float(f), 5) for f in freq], "want": [round(float(f), 5) for f in want],
            "max_abs_err": float((freq - want).abs().max())}
    dist["ok"] = dist["max_abs_err"] < 0.02 and float(freq[3]) == 0.0
    say("kernel-vs-plain", kernel="nucleus_sample", distribution=dist)
    if not dist["ok"]:
        raise AssertionError(f"the sampler kernel's draws are off their distribution: {dist}")
    report.update(name="nucleus_sample", route="cuda", source=f"{REPO}/csrc/nucleus_sample.cu", replaces=None,
                  kernels=[SAMPLER_KERNEL], launches=len(SAMPLER_SHAPES), distribution=dist,
                  ptxas=(ptxas or {}).get("nucleus_sample"))
    say("sampler", ptxas=report["ptxas"])
    return report


# (mode, sequences or clips, keys): the narrator's 640 sequences x 25 heads over its self cache of 77
# positions, and 64 clips x 10 rows over 256 latents
DECODE_SHAPES = (("self", 640, 1), ("self", 640, 33), ("self", 640, 77), ("cross", 64, 256))
DECODE_H, DECODE_DH, DECODE_S, DECODE_R = 25, 64, 77, 10
DECODE_KERNEL = {"self": "decode_sdpa_self_kernel", "cross": "decode_sdpa_cross_kernel"}


def _rel_gap(x, ref) -> float:
    return float((x.float() - ref).norm() / ref.norm())


def phase_decode_attention(device, peaks, ptxas=None) -> dict:
    """The narrator's decode attention kernel (K8) in both modes at the
    benchmark's shapes, through the route ``models/gpt2.py`` calls: against
    its plain version and against SDPA in f32 and bf16, the same bits
    twice, its launches counted; then its time beside the plain version's,
    SDPA's and the bound."""
    import torch
    import torch.nn.functional as F

    from helping_hand_for_egocentric_videos_torch.ops import decode_attention as dec

    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    h, dh, r = DECODE_H, DECODE_DH, DECODE_R
    dec.decode_sdpa_self.launches = dec.decode_sdpa_cross.launches = 0
    rows = []
    for mode, b, keys in DECODE_SHAPES:
        if mode == "self":  # q a view of c_attn's (N, 3, H, dh) rows; k, v as cache.kv[i, 0 / 1]
            n = b
            q = torch.randn(n, 3 * h * dh, generator=gen, device=device).to(torch.bfloat16).view(n, 3, h, dh)[:, 0]
            kv = torch.randn(2, n, h, DECODE_S, dh, generator=gen, device=device).to(torch.bfloat16)
            k, v = kv[0], kv[1]
            fn = partial(dec.self_attention, q, k, v, keys)
            plain = partial(dec.self_attention_ref, q, k, v, keys)

            def sdpa(q, k, v, keys=keys):
                return F.scaled_dot_product_attention(q[:, :, None], k[:, :, :keys], v[:, :, :keys]).reshape(
                    q.shape[0], -1)
            bound_ms, bound_by = decode_attention_bound_ms("self", n, h, keys, dh, "bfloat16", peaks)
            counter = dec.decode_sdpa_self
        else:  # a clip's 10 rows over its (H, M, dh) latent keys and values
            n = b * r
            q = torch.randn(n, h * dh, generator=gen, device=device).to(torch.bfloat16).view(n, h, dh)
            kv = torch.randn(2, b, h, keys, dh, generator=gen, device=device).to(torch.bfloat16)
            k, v = kv[0], kv[1]
            fn = partial(dec.cross_attention, q, k, v, r)
            plain = partial(dec.cross_attention_ref, q, k, v, r)

            def sdpa(q, k, v, b=b):
                out = F.scaled_dot_product_attention(q.view(b, r, h, dh).transpose(1, 2), k, v)
                return out.transpose(1, 2).reshape(b * r, -1)
            bound_ms, bound_by = decode_attention_bound_ms("cross", n, h, keys, dh, "bfloat16", peaks, r=r)
            counter = dec.decode_sdpa_cross
        before = counter.launches
        got, again = fn(), fn()
        launched = counter.launches - before
        ref = plain()
        f32 = sdpa(q.float(), k.float(), v.float())
        lib = sdpa(q, k, v)
        torch.cuda.synchronize()
        err = ((got.float() - ref.float()).abs() - 2 ** -7 * ref.float().abs()).amax()
        res = {"mode": mode, "rows": n, "H": h, "dh": dh, "keys": keys, "launches_two_calls": launched,
               "max_abs_err_vs_plain": float((got.float() - ref.float()).abs().max()),
               "worst_excess_over_rtol": float(err), "gap_to_f32": _rel_gap(got, f32),
               "library_gap_to_f32": _rel_gap(lib, f32), "same_bits": bool(torch.equal(got, again))}
        res["ok"] = (launched == 2 and res["worst_excess_over_rtol"] <= 1e-5 and res["same_bits"]
                     and res["gap_to_f32"] <= res["library_gap_to_f32"])
        say("kernel-vs-plain", kernel="decode_attention", **res)
        if not res["ok"]:
            raise AssertionError(f"the decode-attention kernel disagrees with its plain version or SDPA: {res}")
        events_ms = cuda_ms(fn, 20)
        try:  # the kernel alone; a trace that lost a launch's event reads nothing
            ms = device_ms(fn, 20, DECODE_KERNEL[mode])
        except RuntimeError as e:
            say("kernel-timing", kernel="decode_attention", trace=str(e))
            ms = events_ms
        timing = {"mode": mode, "rows": n, "keys": keys, "ms": ms, "events_ms": events_ms,
                  "plain_ms": cuda_ms(plain, 3), "library_ms": cuda_ms(partial(sdpa, q, k, v), 20),
                  "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms,
                  "plan": dec.plan(mode, keys if mode == "cross" else 256)}
        say("kernel-timing", kernel="decode_attention", **timing)
        rows.append({**res, **timing})
        del q, kv, k, v, got, again, ref, f32, lib
        torch.cuda.empty_cache()
    launches = dec.launches()
    report = {"name": "decode_attention", "route": "cuda", "source": f"{REPO}/csrc/decode_attention.cu",
              "replaces": None, "kernels": list(DECODE_KERNEL.values()), "launches": launches,
              "tolerance": "plain version rtol 2^-7 (atol 1e-5); relative gap to f32 SDPA <= bf16 SDPA's",
              "shapes": rows, "ptxas": (ptxas or {}).get("decode_attention")}
    say("decode-attention", launches=launches, ptxas=report["ptxas"])
    return report


# (prefix, tail): Kimi-VL's decode step, 64 clips x 10 sequences x 16 heads a row, over a clip's 600 prefix
# positions and the sequence's first, middle and last tail lengths
LATENT_SHAPES = ((600, 1), (600, 33), (600, 77))
LATENT_ROWS, LATENT_SCALE = 10240, 192 ** -0.5
LATENT_KERNEL = "latent_softmax_kernel"


def phase_latent_softmax(device, peaks, ptxas=None) -> dict:
    """Kimi-VL's merged latent softmax (K9) at its decode step's shapes:
    against its plain version, the same bits twice, its launches counted;
    then its time beside the plain version's, the library route's and the
    bound."""
    import torch

    from helping_hand_for_egocentric_videos_torch.ops import latent_attention as la

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    rows = []
    for p, t in LATENT_SHAPES:
        s_pre = 20 * torch.randn(LATENT_ROWS, p, generator=gen, device=device)
        s_tail = 20 * torch.randn(LATENT_ROWS, t, generator=gen, device=device)
        fn = partial(la.latent_softmax, s_pre, s_tail, LATENT_SCALE)
        la.latent_softmax.launches = 0
        got, again = fn(), fn()
        launched = la.latent_softmax.launches
        want = la.latent_softmax_ref(s_pre, s_tail, LATENT_SCALE, torch.float32)
        torch.cuda.synchronize()
        got_all, want_all = torch.cat(got, -1).float(), torch.cat(want, -1)
        res = {"rows": LATENT_ROWS, "prefix": p, "tail": t, "launches_two_calls": launched,
               "max_abs_err_vs_plain": float((got_all - want_all).abs().max()),
               "worst_excess_over_rtol": float(((got_all - want_all).abs() - 2 ** -8 * want_all - 1e-6).amax()),
               "bf16_equal_share": float((got_all == want_all.to(torch.bfloat16).float()).float().mean()),
               "row_sum_err": float((got_all.sum(-1) - 1).abs().max()),
               "same_bits": all(torch.equal(a, b) for a, b in zip(got, again))}
        res["ok"] = launched == 2 and res["worst_excess_over_rtol"] <= 0 and res["same_bits"]
        say("kernel-vs-plain", kernel="latent_softmax", **res)
        if not res["ok"]:
            raise AssertionError(f"the latent softmax kernel disagrees with its plain version: {res}")
        events_ms = cuda_ms(fn, 20)
        try:  # the kernel alone; a trace that lost a launch's event reads nothing
            ms = device_ms(fn, 20, LATENT_KERNEL)
        except RuntimeError as e:
            say("kernel-timing", kernel="latent_softmax", trace=str(e))
            ms = events_ms
        # the library route: the two score products written into one buffer's slices, or concatenated
        scores = torch.cat([s_pre, s_tail], -1)
        bound_ms, bound_by = latent_softmax_bound_ms(LATENT_ROWS, p, t, peaks)
        timing = {"rows": LATENT_ROWS, "prefix": p, "tail": t, "ms": ms, "events_ms": events_ms,
                  "plain_ms": cuda_ms(partial(la.latent_softmax_ref, s_pre, s_tail, LATENT_SCALE, torch.bfloat16), 5),
                  "library_ms": cuda_ms(lambda: torch.softmax(scores, -1).to(torch.bfloat16), 20),
                  "library_cat_ms": cuda_ms(
                      lambda: torch.softmax(torch.cat([s_pre, s_tail], -1), -1).to(torch.bfloat16), 20),
                  "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / ms}
        say("kernel-timing", kernel="latent_softmax", **timing)
        rows.append({**res, **timing})
        del s_pre, s_tail, got, again, want, got_all, want_all, scores
        torch.cuda.empty_cache()
    report = {"name": "latent_softmax", "route": "cuda", "source": f"{REPO}/csrc/latent_softmax.cu",
              "replaces": None, "kernels": [LATENT_KERNEL], "launches": 2 * len(LATENT_SHAPES),
              "tolerance": "plain version rtol 2^-8 atol 1e-6", "shapes": rows,
              "ptxas": (ptxas or {}).get("latent_softmax")}
    say("latent-softmax", ptxas=report["ptxas"])
    return report


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
    res["bound_ms"], res["bound_by"] = attention_bound_ms(b, t, N, HEADS, DH, "bfloat16", "time", peaks)
    res.update(bound_share=res["bound_ms"] / res["ms"], vs_library=res["ms"] / res["library_ms"],
               plan=da.headgrid_plan(t, b * N * HEADS, DH))
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
        bound_ms={"int8": 1e3 * ops / peaks["int8"], "bfloat16": 1e3 * ops / peaks["bfloat16"]})
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
    want = dict.fromkeys(counters(), 0)
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


def _renamed(sd: dict, names, prefix: str = "") -> dict:
    """A port state dict -> f32 CPU tensors under the reference's names
    (``names``: regex rewrites, then ``prefix``), q/k/v packed."""
    out = {}
    for k, v in sd.items():
        for pat, rep in names:
            k = re.sub(pat, rep, k)
        out[prefix + k] = v.detach().float().cpu()
    return _pack_mha(out)


def reference_state_dicts(backbone, decoder, vcfg) -> tuple[dict, dict]:
    """The port's ``Lavila`` and ``ObjDecoder`` -> f32 CPU state dicts in the
    reference's layout, the inverse of ``models/weights.py``: the flat
    channel-last patch Linear back to the (D, C, P, P) conv, q/k/v packed."""
    lsd = _renamed(backbone.state_dict(), _LAVILA_NAMES)
    w = lsd.pop("visual.patch_embed.weight")
    p = vcfg.patch_size
    lsd["visual.patch_embed.proj.weight"] = w.reshape(w.shape[0], p, p, vcfg.in_chans).permute(0, 3, 1, 2).contiguous()
    return lsd, _renamed(decoder.state_dict(), _DECODER_NAMES)


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


def write_reference_checkpoints(root, device, seed, backbone="timesformer_large"):
    """Seeded random weights at the full width of ``backbone`` and of the
    13-query decoder (with its trajectory head), both at ``CKPT_T`` frames
    as LaviLa releases them, time attention and the temporal embedding
    N(0, 0.02) (a non-zero time attention; an inflation that shows),
    written under ``root`` in the reference's layout. -> (backbone path,
    decoder path, the Lavila, the ObjDecoder, seconds to write)."""
    import torch

    from helping_hand_for_egocentric_videos_torch.models import DecoderConfig, Lavila, ObjDecoder, lavila

    # the CLI's projection width (its ExperimentConfig), 256
    lcfg = getattr(lavila, f"{backbone}_config")(num_frames=CKPT_T, project_embed_dim=256)
    dcfg = DecoderConfig(num_queries=13, feature_dim=lcfg.visual.width, text_width=lcfg.text.width,
                         num_frames=CKPT_T, patches_per_frame=lcfg.visual.patches_per_frame, pred_traj=True)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Lavila(lcfg, generator=gen, device=device)
    decoder = ObjDecoder(dcfg, generator=gen, device=device)
    with torch.no_grad():
        for blk in model.visual.blocks:
            blk.timeattn.qkv.weight.normal_(0.0, 0.02, generator=gen)
            blk.timeattn.proj.weight.normal_(0.0, 0.02, generator=gen)
        model.visual.temporal_embed.normal_(0.0, 0.02, generator=gen)
    t0 = time.perf_counter()
    lsd, dsd = reference_state_dicts(model, decoder, lcfg.visual)
    bpath, dpath = f"{root}/lavila_{backbone}_{CKPT_T}f.pth", f"{root}/decoder_nq12_{CKPT_T}f.pth.tar"
    torch.save({f"module.{k}": v for k, v in lsd.items()}, bpath)
    torch.save({"state_dict": dsd, "epoch": 0}, dpath)
    return bpath, dpath, model, decoder, time.perf_counter() - t0


def phase_serve_long(card, device="cuda", backbone="timesformer_large", frames=LONG_T):
    """Write reference-layout checkpoints of seeded random weights at 4
    frames, then serve them with ``cli.serve`` at ``frames`` in bf16 and
    in int8. -> (bf16 model, int8 model, launches of the two runs)."""
    import torch

    BUILD.mkdir(exist_ok=True)
    served = {}
    with tempfile.TemporaryDirectory(dir=BUILD, prefix="serve_long_") as tmp:
        bpath, dpath, model, decoder, write_s = write_reference_checkpoints(tmp, device, SEED + 4, backbone)
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
    return served[False][0], served[True][0], {k: served[False][1][k] + served[True][1][k] for k in counters()}


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


def phase_train(card, peaks, device="cuda", backbone_name="timesformer_large", b=TRAIN_B):
    """The pretraining step at full width: kernel route vs plain route,
    8 steps with dropout (launch counts, frozen parameters, no host sync),
    then timing. -> (launches of the main path, the checks and timing)."""
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
    return launches, {"vs_plain": vs_plain, "timing": timing}


# ---------------------------------------------------------------- the loop
LOOP_ITEMS, LOOP_T = 16, 4  # --batch_size 16 items a step; with their negatives 32 clips
LOOP_STEPS, LOOP_EVERY, LOOP_RESUME_TO, LOOP_REF_STEPS, LOOP_PROFILE_STEP = 12, 6, 16, 3, 14
LOOP_MCQ, LOOP_EVAL_ITEMS_PER_FORWARD = 40, 4  # EgoMCQ items; run_egomcq's items a forward
LOOP_NOUNS = ("onion", "board", "knife", "fridge", "cup", "sink", "drawer", "plate")
LOOP_CAPTIONS = ("#C C cuts the onion on the board", "#C C opens the fridge", "#C C washes the knife in the sink",
                 "#C C picks up a cup from the drawer", "#C C puts the plate on the board")
LOOP_FPS, LOOP_FRAMES, LOOP_HW = 30, 90, (256, 456)  # chunks at the reference's 256-pixel short side


def write_egoclip_fixture(root: Path, rows: int = LOOP_ITEMS * LOOP_STEPS, mcq: int = LOOP_MCQ,
                          noun_width: int = 768) -> tuple[str, str]:
    """A synthetic EgoClip layout under ``root`` -> (meta_dir, data_dir):
    two videos of seeded uint8 frames as chunked
    ``videos_256_chunked/<uid>/0.mp4.npy`` (90 frames of 256 x 456),
    ``egoclip.csv`` with ``rows`` narrations whose nouns are in the
    taxonomy, hand-object detections for every clip (so the box losses
    see boxes), ``egomcq.json`` with ``mcq`` items of 5 choices of both
    types, the 582-noun taxonomy and a seeded (582, ``noun_width``)
    ``noun_dict_lavila_embeds.pth``, and no rephrased captions (so the
    four extra caption rows are padding)."""
    import pickle

    import torch

    rng = np.random.default_rng(SEED + 11)
    meta, data = root / "meta", root / "data"
    meta.mkdir(parents=True, exist_ok=True)
    uids = ("vid_000", "vid_001")
    starts = [round(0.05 * (i // 2) % 2.4, 2) for i in range(rows)]
    for uid in uids:
        vdir = data / "videos_256_chunked" / uid
        vdir.mkdir(parents=True, exist_ok=True)
        np.save(vdir / "0.mp4.npy", rng.integers(0, 256, size=(LOOP_FRAMES, *LOOP_HW, 3), dtype=np.uint8))
        hdir = data / "hand_object_clip_per_video_4f_lavila_narrator_640" / uid
        hdir.mkdir(parents=True, exist_ok=True)
        info = {}
        for start in sorted(set(starts)):
            per_clip = {}
            for f in range(4):
                xy = rng.random((3, 2)) * [300, 150]
                wh = 30 + rng.random((3, 2)) * 100
                dets = np.concatenate([xy, xy + wh, rng.random((3, 1))], 1)
                per_clip[f] = {"hand_dets": dets[:2], "obj_dets": dets[2:]}
            per_clip["info"] = {"height": LOOP_HW[0], "width": LOOP_HW[1]}
            info[round(start, 3)] = per_clip
        with open(hdir / "0.handobj.pkl", "wb") as fh:
            pickle.dump(info, fh)
    lines = ["video_uid\tclip_start\tclip_end\tclip_text\ttag_noun\ttag_verb\tnarration_time"]
    for i, start in enumerate(starts):
        cap = LOOP_CAPTIONS[i % len(LOOP_CAPTIONS)]
        tags = [1 + LOOP_NOUNS.index(n) for n in LOOP_NOUNS if n in cap]
        lines.append(f"{uids[i % 2]}\t{start}\t{start + 0.5}\t{cap}\t{tags}\t[{i % 7}]\t{start}")
    (meta / "egoclip.csv").write_text("\n".join(lines))

    def choice(k):
        start = round(0.1 + 0.23 * k % 2.4, 2)
        cap = LOOP_CAPTIONS[k % len(LOOP_CAPTIONS)]
        return {"video_uid": uids[k % 2], "clip_start": start, "clip_end": start + 0.5, "clip_text": cap,
                "tag_noun": "[1]", "tag_verb": "[0]", "narration_time": start}

    items = {str(q): {"query": choice(q), "choices": {str(i): choice(q + i) for i in range(5)}, "answer": q % 5,
                      "types": 1 + q % 2} for q in range(mcq)}
    (meta / "egomcq.json").write_text(json.dumps(items))
    names = ["pad", *LOOP_NOUNS] + [f"noun{i}" for i in range(1 + len(LOOP_NOUNS), TRAIN_NOUNS)]
    groups = ["group"] + [json.dumps([n]).replace('"', "'") for n in names]
    (meta / "narration_noun_taxonomy.csv").write_text("\n".join(f'"{g}"' for g in groups))
    gen = torch.Generator().manual_seed(SEED + 12)
    torch.save({n: torch.randn(noun_width, generator=gen) for n in names}, meta / "noun_dict_lavila_embeds.pth")
    return str(meta), str(data)


def _loop_argv(meta, data, out, name, *extra):
    return ["--meta_dir", meta, "--data_dir", data, "--output_dir", str(out), "--name", name,
            "--batch_size", str(LOOP_ITEMS), "--num_frames", str(LOOP_T), "--lr", str(TRAIN_LR), "--epochs", "1",
            "--eval_freq", str(LOOP_EVERY), "--runtime_save_iter", str(LOOP_EVERY), *extra]


def _loop_sets(*extra):
    return ["--set", "data.loading=strict", f"optim.log_flush_iter={LOOP_EVERY}", "optim.keep_checkpoints=2", *extra]


def _jsonl(path) -> list[dict]:
    return [json.loads(line) for line in open(path)]


def _run_loop(argv, keep_backbone: bool = False) -> dict:
    """``cli.train.main(argv)`` with the launch counts set to 0 just before
    and read just after; the models the run builds are snapshotted as
    built. -> the run's state, logs, launches, peak memory, and whether the
    backbone, ``class_embed`` and ``vid_proj`` are as built and every
    logged metric finite; with ``keep_backbone`` the backbone too."""
    import gc

    import torch

    from helping_hand_for_egocentric_videos_torch.cli import train as cli_train
    from helping_hand_for_egocentric_videos_torch.train import pretrain as tpre

    built, real = {}, tpre.build_models

    def snapshot_build(cfg, seed=0):
        models = real(cfg, seed)
        built["models"] = models
        built["backbone"] = {k: v.clone() for k, v in models[1].state_dict().items()}
        built["frozen"] = {k: v.clone() for k, v in models[3].state_dict().items()
                           if k.split(".")[0] in ("class_embed", "vid_proj")}
        return models

    args = cli_train.parse_args(argv)
    exp = Path(args.output_dir) / args.name
    tpre.build_models = snapshot_build
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        # ---- the main path: counts set to 0 just before, read just after
        reset_counts()
        state, best = cli_train.main(argv)
        torch.cuda.synchronize()
        launches = read_counts()
        # ----
    finally:
        tpre.build_models = real
    seconds = time.perf_counter() - t0
    train, val = _jsonl(exp / "train_metrics.jsonl"), _jsonl(exp / "val_metrics.jsonl")
    backbone = built["models"][1]
    res = {
        "state": state, "best": best, "exp": exp, "train": train, "val": val, "launches": launches,
        "seconds": seconds, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "backbone_unchanged": all(torch.equal(v.cpu(), backbone.state_dict()[k].cpu())
                                  for k, v in built["backbone"].items()),
        "frozen_unchanged": all(torch.equal(v.to(state.decoder.state_dict()[k].device), state.decoder.state_dict()[k])
                                for k, v in built["frozen"].items()),
        "finite": all(np.isfinite(v) for r in train + val for k, v in r.items() if k not in ("step", "time")),
    }
    if keep_backbone:
        res["backbone"] = backbone
    del built, backbone
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _expect_launches(run, per_forward, steps, evals) -> dict:
    """The launches a run must make: ``per_forward`` for each train step and
    for each eval forward (``run_egomcq`` takes 4 items, 20 clips, a
    forward)."""
    eval_forwards = sum(-(-int(r["egomcq/n_items"]) // LOOP_EVAL_ITEMS_PER_FORWARD) for r in evals)
    want = {k: v * (steps + eval_forwards) for k, v in per_forward.items()}
    if run["launches"] != want:
        raise AssertionError(f"{run['launches']} launches for {steps} steps and {eval_forwards} eval forwards, "
                             f"want {per_forward} each")
    return {"train_steps_counted": steps, "eval_forwards": eval_forwards}


def _trace_busy(path) -> dict:
    """A traced loop step's wall time (first to last event of the trace,
    the step and the wait for the device), the device's busy time (the
    kernels' and copies' durations) and its idle share, and the kernels
    launched."""
    from helping_hand_for_egocentric_videos_torch.utils.profiling import _DEVICE, _HOST

    # the host's operators and CUDA calls and the device's work: not the
    # profiler's own span of its window, which takes in its idle margins
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in _DEVICE + _HOST]
    device = [e for e in events if e.get("cat") in _DEVICE]
    wall = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e3
    busy = sum(e["dur"] for e in device) / 1e3
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "kernels": sum(e.get("cat") == "kernel" for e in device)}


def _window_ms(train) -> list[float]:
    """The training ms a step of each flush window (``loop/`` rows)."""
    return [1e3 * r["loop/seconds"] / r["loop/steps"] for r in train if "loop/seconds" in r]


def _losses(train) -> dict:
    return {r["step"]: r["local/total_loss"] for r in train if "local/total_loss" in r}


def phase_train_loop(card, root: Path):
    """"train-loop": ``cli.train.main`` at full width (TimeSformer-L/14, 4
    frames, 224 x 224, the 13-query decoder), 16 items a step (32 clips
    with their negatives), augmentation on with colour jitter, one epoch
    of 12 steps evaluating and saving every 6, the steps between flushes
    under ``set_sync_debug_mode("error")``; then resumed from the last
    checkpoint to step 16. -> launches of the main path."""
    from types import SimpleNamespace

    from helping_hand_for_egocentric_videos_torch.models import lavila

    meta, data = write_egoclip_fixture(root / "egoclip")
    out = root / "runs"
    per_forward = launches_per_forward(SimpleNamespace(lavila_cfg=lavila.timesformer_large_config(LOOP_T),
                                                       int8=False))
    jitter = "data.color_jitter=0.3,0.3,0.05"
    run = _run_loop(_loop_argv(meta, data, out, "loop", "--augment", "--sync_debug", "error",
                               *_loop_sets(jitter)))
    counts = _expect_launches(run, per_forward, LOOP_STEPS, run["val"])
    exp = run["exp"]
    ckpts = sorted(os.listdir(exp / "checkpoints"))
    best = sorted(os.listdir(exp / "best")) if (exp / "best").exists() else []
    # best/ holds the first eval that reached the highest Inter-video accuracy, if it beat 0
    inter = [(r["egomcq/Inter-video"], -r["step"]) for r in run["val"]]
    top = max(inter)
    want_best = [f"step_{-top[1]:08d}"] if top[0] > 0 else []
    windows = [r for r in run["train"] if "loop/steps_per_s" in r]
    steady = windows[-1]  # steps 7-12: past the first step's set-up
    timing = {"card": card, "items_per_step": LOOP_ITEMS, "clips_per_step": 2 * LOOP_ITEMS,
              "steps_per_s": steady["loop/steps_per_s"], "clips_per_s": steady["loop/steps_per_s"] * 2 * LOOP_ITEMS,
              "step_ms": 1e3 / steady["loop/steps_per_s"], "data_share": steady["loop/data_share"],
              "data_ms_per_step": 1e3 * steady["loop/data_share"] / steady["loop/steps_per_s"],
              "window_steps": steady["loop/steps"], "windows": windows, "peak_memory_gb": run["peak_memory_gb"],
              "run_seconds": run["seconds"]}
    res = {"steps": run["state"].step, "checkpoints": ckpts, "best": best, "best_expected": want_best,
           "val": run["val"],
           "launches": run["launches"], "launches_per_step": per_forward, **counts,
           "finite": run["finite"], "backbone_unchanged": run["backbone_unchanged"],
           "class_embed_vid_proj_unchanged": run["frozen_unchanged"], "sync_debug_mode": "error, steps 2-5 and 7-11",
           "total_loss": _losses(run["train"])}
    del run

    # the resumed run also traces step 14 (utils/profiling.py) for the step's device busy share
    resumed = _run_loop(_loop_argv(meta, data, out, "loop", "--augment", "--epochs", "2", "--max_steps",
                                   str(LOOP_RESUME_TO), "--runtime_save_iter", "4",
                                   *_loop_sets(jitter, f"optim.profile_step={LOOP_PROFILE_STEP}")))
    timing["traced_step"] = _trace_busy(exp / "profile" / "trace.json")
    more = LOOP_RESUME_TO - LOOP_STEPS
    counts2 = _expect_launches(resumed, per_forward, more, [r for r in resumed["val"] if r["step"] > LOOP_STEPS])
    ckpts2 = sorted(os.listdir(exp / "checkpoints"))
    new_steps = sorted(s for s in _losses(resumed["train"]) if s > LOOP_STEPS)
    res["resume"] = {"steps": resumed["state"].step, "logged_steps": new_steps, "checkpoints": ckpts2,
                     "finite": resumed["finite"], "backbone_unchanged": resumed["backbone_unchanged"],
                     "class_embed_vid_proj_unchanged": resumed["frozen_unchanged"], **counts2}
    launches = {k: v + resumed["launches"][k] for k, v in res["launches"].items()}
    del resumed
    say("train-loop", **res)
    say("train-loop-timing", **timing)
    ok = (res["steps"] == LOOP_STEPS and ckpts == ["step_00000006", "step_00000012"] and best == want_best
          and len(res["val"]) == 2 and res["finite"] and res["backbone_unchanged"]
          and res["class_embed_vid_proj_unchanged"] and res["resume"]["steps"] == LOOP_RESUME_TO
          and new_steps == list(range(LOOP_STEPS + 1, LOOP_RESUME_TO + 1))
          and ckpts2 == ["step_00000012", "step_00000016"] and res["resume"]["finite"]
          and res["resume"]["backbone_unchanged"] and res["resume"]["class_embed_vid_proj_unchanged"])
    if not ok:
        raise AssertionError("the training loop did not run, save, evaluate or resume as it must (train-loop line)")
    return launches, (meta, data), timing


def phase_train_loop_int8(card, fixture, root: Path):
    """"train-loop-int8": the loop with ``--int8_backbone`` for 3 steps,
    and the same run in bf16 (augmentation off, the same seed and batches)
    as its reference: K3-K5 launched as the int8 route implies, the first
    loss within 5e-2 relative of the bf16 loop's. -> (launches, the bf16
    run's losses)."""
    from types import SimpleNamespace

    from helping_hand_for_egocentric_videos_torch.models import lavila

    meta, data = fixture
    lcfg = lavila.timesformer_large_config(LOOP_T)
    bf16_forward = launches_per_forward(SimpleNamespace(lavila_cfg=lcfg, int8=False))
    int8_forward = launches_per_forward(SimpleNamespace(lavila_cfg=lcfg, int8=True))
    # one loader thread: the dataset draws its negatives from one generator,
    # in the order its threads ask (ROADMAP.md, section C), so only then are
    # the batches of two runs the same
    steps = ["--max_steps", str(LOOP_REF_STEPS), "--num_workers", "1"]
    ref = _run_loop(_loop_argv(meta, data, root / "runs", "ref", *steps, *_loop_sets()))
    ref_counts = _expect_launches(ref, bf16_forward, LOOP_REF_STEPS, ref["val"])
    q = _run_loop(_loop_argv(meta, data, root / "runs", "int8", "--int8_backbone", *steps, *_loop_sets()))
    q_counts = _expect_launches(q, int8_forward, LOOP_REF_STEPS, q["val"])
    ref_losses, q_losses = _losses(ref["train"]), _losses(q["train"])
    rel = abs(q_losses[1] - ref_losses[1]) / abs(ref_losses[1])
    res = {"card": card, "steps": q["state"].step, "launches_per_step": int8_forward, "launches": q["launches"],
           **q_counts, "int8_total_loss": q_losses, "bf16_total_loss": ref_losses, "first_loss_rel_err": rel,
           "rtol": 5e-2, "finite": q["finite"], "backbone_unchanged": q["backbone_unchanged"],
           "class_embed_vid_proj_unchanged": q["frozen_unchanged"], "bf16_reference": ref_counts,
           "int8_val": q["val"], "bf16_val": ref["val"], "peak_memory_gb": q["peak_memory_gb"],
           # a window a step (every step flushes and waits for the device); the first holds the set-up
           "int8_step_ms": _window_ms(q["train"]), "bf16_step_ms": _window_ms(ref["train"])}
    say("train-loop-int8", **res)
    if not (q["state"].step == LOOP_REF_STEPS and rel <= 5e-2 and q["finite"] and ref["finite"]
            and q["backbone_unchanged"] and q["frozen_unchanged"]):
        raise AssertionError("the int8 loop disagrees with the bf16 loop or did not run (train-loop-int8 line)")
    launches = {k: v + ref["launches"][k] for k, v in q["launches"].items()}
    return launches, ref_losses


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_train_loop_dist(card, fixture, root: Path, ref_losses: dict):
    """"train-loop-dist": the loop as one ``torchrun``-style rank (RANK=0,
    WORLD_SIZE=1, LOCAL_RANK=0, MASTER_ADDR/PORT), so through ``nccl`` and
    the all-gather / all-reduce code; its first 3 losses (augmentation
    off) within 1e-4 relative of the one-process loop's. -> launches."""
    from types import SimpleNamespace

    import torch
    import torch.distributed as dist

    from helping_hand_for_egocentric_videos_torch.models import lavila

    meta, data = fixture
    per_forward = launches_per_forward(SimpleNamespace(lavila_cfg=lavila.timesformer_large_config(LOOP_T),
                                                       int8=False))
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port())}
    os.environ.update(env)
    try:
        run = _run_loop(_loop_argv(meta, data, root / "runs", "dist", "--max_steps", str(LOOP_REF_STEPS),
                                   "--num_workers", "1", *_loop_sets()))
    finally:
        for k in env:
            os.environ.pop(k, None)
    counts = _expect_launches(run, per_forward, LOOP_REF_STEPS, run["val"])
    losses = _losses(run["train"])
    rel = {s: abs(losses[s] - ref_losses[s]) / abs(ref_losses[s]) for s in ref_losses}
    res = {"card": card, "env": env, "backend": "nccl" if torch.cuda.is_available() else "gloo",
           "group_destroyed": not dist.is_initialized(),
           "total_loss": losses, "one_process_total_loss": ref_losses, "rel_err": rel, "rtol": 1e-4,
           "launches": run["launches"], **counts, "finite": run["finite"]}
    say("train-loop-dist", **res)
    if not (sorted(rel) == list(range(1, LOOP_REF_STEPS + 1)) and max(rel.values()) <= 1e-4 and run["finite"]
            and res["group_destroyed"]):
        raise AssertionError("the one-rank nccl loop disagrees with the one-process loop (train-loop-dist line)")
    return run["launches"]


# ---------------------------------------------------------------- the model axis
TP_RANKS, TP_TIMED = 2, 2  # ranks of one model group on the card; timed steps
TP_MCQ = 8  # EgoMCQ items of the loop's fixture: 2 eval forwards of 20 clips (each moves ~6 GB through gloo)
TP_GRAD_COS = 0.999  # bf16 split step against the one-process bf16 step: the gradients' cosine
TP_LOSSES = ("total_loss", "nce_loss", "box_loss", "word_loss")  # the loss terms compared in bf16
TP_BF16_LOSS_RTOL = 1e-4  # bf16 split step against the one-process bf16 step: each loss term
# f32 split step against one process: the backbone's outputs (video grid,
# text feature map), the largest difference over the largest value
TP_FEATURE_RTOL = 1e-5
# f32 split step against one process, the decoder's ReLU pattern the same:
# the gradients within this x max(1, grad_norm)
TP_MASKED_GRAD_RTOL = 1e-5
# the loops compared in f32: in bf16 the split sum rounds once where one GEMM
# rounds once, a last-bit difference that Adam's first update (+-lr a weight)
# turns into 2.5e-4 of the loss by step 2 (a rehearsal on the CPU, tiny backbone)
TP_LOOP_SET = "parallel.backbone_dtype=float32"
# the loop's online EgoMCQ runs in bf16 (as JAX's): split against one process,
# the largest difference of a similarity, set before the first run on the card;
# an item may pick another clip only where its two best are closer than twice that
TP_SIM_ATOL = 5e-3


@contextlib.contextmanager
def _egomcq_sims(prefix: Path):
    """Keep the similarity rows of every online EgoMCQ of a loop in this
    process (``run_egomcq``'s ``out_sims``), as ``<prefix>_<i>.npz``; the
    run is otherwise unchanged. Yields the list of files written."""
    from helping_hand_for_egocentric_videos_torch.train import pretrain as tpre

    real, paths = tpre.run_egomcq, []

    def probe(model, dataset, **kw):
        paths.append(f"{prefix}_{len(paths)}.npz")
        return real(model, dataset, out_sims=paths[-1], **kw)

    tpre.run_egomcq = probe
    try:
        yield paths
    finally:
        tpre.run_egomcq = real


def _egomcq_agree(got: str, want: str) -> dict:
    """Two runs' EgoMCQ similarity rows: the largest difference, and the
    items whose picked clip differs with the gap between the one-process
    run's two best clips there."""
    g, w = np.load(got)["sims"], np.load(want)["sims"]
    err = float(np.abs(g - w).max())
    top2 = np.sort(w, axis=1)[:, -2:]
    flips = np.nonzero(g.argmax(1) != w.argmax(1))[0]
    gaps = (top2[flips, 1] - top2[flips, 0]).tolist()
    return {"sims_max_abs_err": err, "sims_atol": TP_SIM_ATOL, "items": int(w.shape[0]),
            "items_picking_another_clip": flips.tolist(), "their_top2_gaps": gaps,
            "ok": err <= TP_SIM_ATOL and all(gap <= 2 * err for gap in gaps)}


def _tp_step(dcfg, lcfg, tcfg, decoder, backbone, batch, noun_dict, device, dp=None, mp=None):
    """One step, dropout off, from a copy of ``decoder``; with ``dp`` and
    ``mp`` this rank's rows and this rank's shard ``backbone``. -> (metrics,
    gradients by name, the updated parameters flat, the state, the step)."""
    import copy

    import torch

    from helping_hand_for_egocentric_videos_torch.train import TrainState, make_train_step

    state = TrainState.create(copy.deepcopy(decoder), tcfg, device=device)
    step = make_train_step(dcfg, lcfg, tcfg, dist=dp, mp=mp)
    if dp is not None:
        batch = {k: v[dp.rows(v.shape[0])] for k, v in batch.items()}
    state, m = step(state, backbone, batch, noun_dict)
    grads = {n: p.grad.detach().clone() for n, p in state.decoder.named_parameters() if p.grad is not None}
    flat = torch.cat([p.detach().reshape(-1) for p in state.decoder.parameters()])
    return {k: float(v) for k, v in m.items()}, grads, flat, state, step


def _steps_ms(state, step, backbone, batch, noun_dict, n: int) -> float | None:
    """The mean ms of ``n`` more steps of a step that has run (warm),
    between CUDA events (None on the CPU, where the phases are rehearsed)."""
    import torch

    if next(state.decoder.parameters()).device.type != "cuda":
        return None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        state, _ = step(state, backbone, batch, noun_dict)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


@contextlib.contextmanager
def _recording_features(into: list):
    """Keep a copy of the backbone's outputs (video grid, text feature map)
    of every train step run within, in ``into``, in host memory (the
    peaks of device memory stay the steps'); the steps are otherwise
    unchanged."""
    from helping_hand_for_egocentric_videos_torch.train import step as tstep

    real = tstep.backbone_features

    def probe(*args, **kw):
        out = real(*args, **kw)
        into.append([z.detach().to("cpu", copy=True) for z in out])
        return out

    tstep.backbone_features = probe
    try:
        yield into
    finally:
        tstep.backbone_features = real


@contextlib.contextmanager
def _row_split_in_halves(backbone):
    """Within: every product of a row-split weight of the whole ``backbone``
    (``spec_for_param`` 1: proj, mlp_fc2, wo, mlp_proj) is the sum of its
    two halves' f32 partial products, then the bias, the order in which two
    model ranks sum it, in one process; the column-split products and the
    attention keep the one-card shapes. Not for the counted runs. Yields
    a list that grows by one a product made so."""
    import torch.nn.functional as F

    from helping_hand_for_egocentric_videos_torch.parallel import spec_for_param

    rows = {id(p) for n, p in backbone.named_parameters() if spec_for_param(n) == 1}
    real, made = F.linear, []

    def halves(x, w, b=None):
        if id(w) not in rows:
            return real(x, w, b)
        made.append(1)
        k = w.shape[1] // 2
        out = real(x[..., :k], w[:, :k]) + real(x[..., k:], w[:, k:])
        return out if b is None else out + b

    F.linear = halves
    try:
        yield made
    finally:
        F.linear = real


@contextlib.contextmanager
def _recording_attention_shapes(into: set):
    """Add (mode, heads, B, T, dtype) of every K1/K2 call of the visual
    tower made within to ``into``; the calls are otherwise unchanged."""
    from helping_hand_for_egocentric_videos_torch.models import spacetime_vit as tsv

    real = tsv.divided_patch_attention

    def probe(qkv, *args, mode, heads, **kw):
        into.add((mode, heads, qkv.shape[0], qkv.shape[1], str(qkv.dtype).removeprefix("torch.")))
        return real(qkv, *args, mode=mode, heads=heads, **kw)

    tsv.divided_patch_attention = probe
    try:
        yield into
    finally:
        tsv.divided_patch_attention = real


@contextlib.contextmanager
def _given_features(features, device):
    """Within: the train step takes ``features`` (video grid, text feature
    map) on ``device`` in place of its backbone's forward; the rest of the
    step is unchanged."""
    from helping_hand_for_egocentric_videos_torch.train import step as tstep

    real, given = tstep.backbone_features, tuple(z.to(device) for z in features)
    tstep.backbone_features = lambda *args, **kw: given
    try:
        yield
    finally:
        tstep.backbone_features = real


@contextlib.contextmanager
def _relu_pattern(record: list | None = None, impose: list | None = None):
    """Within: each ``torch.relu`` call (the object decoder's) adds its
    pattern (x > 0) to ``record``; or, with ``impose``, passes x where the
    pattern of the same call, in order, holds (x * pattern), so that its
    backward takes that pattern whatever the sign of x."""
    import torch

    real, given = torch.relu, iter(impose or ())

    def relu(x):
        if impose is not None:
            return x * next(given)
        if record is not None:
            record.append(x.detach() > 0)
        return real(x)

    torch.relu = relu
    try:
        yield
    finally:
        torch.relu = real


def _grad_gap(got: dict, want: dict) -> dict:
    """Two steps' gradients: the largest difference, the parameter it is
    in, and that parameter's largest gradient."""
    errs = {n: float((got[n] - g).abs().max()) for n, g in want.items()}
    worst = max(errs, key=errs.get)
    return {"max_abs_err": errs[worst], "param": worst, "param_max_abs_grad": float(want[worst].abs().max())}


def _feature_gap(got: list, want: list) -> dict:
    """Two steps' backbone outputs: each one's largest difference over its
    largest value."""
    return {name: float((g - w).abs().max() / w.abs().max())
            for name, g, w in zip(("video_grid", "text_fmap"), got[0], want[0])}


def _peak_gb(device):
    import torch

    return torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None


def tp_worker(rank: int, port: int, out: str, meta: str, data: str, device: str = "cuda",
              backbone_name: str = "timesformer_large"):
    """One of the ``TP_RANKS`` ``gloo`` ranks of "train-tp" and
    "train-loop-tp", all on ``cuda:0`` (``nccl`` refuses two ranks on one
    card): one model group and one data group. Writes its results to
    ``out/rank<r>.json``; rank 0 also holds the one-process references.
    ``device="cpu"`` with a small ``backbone_name`` rehearses it on the CPU
    (no times, no memory)."""
    import gc

    import torch
    import torch.distributed as dist

    from helping_hand_for_egocentric_videos_torch.cli import train as cli_train
    from helping_hand_for_egocentric_videos_torch.models.spacetime_vit import block_routes
    from helping_hand_for_egocentric_videos_torch.parallel import make_groups, shard_lavila
    from helping_hand_for_egocentric_videos_torch.train import TrainConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the loop's cli.train reads these and reuses the group started here
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(TP_RANKS), LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    device = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=TP_RANKS)
    dp, mp = make_groups(TP_RANKS, TP_RANKS, device)
    res = {"rank": rank, "backend": dist.get_backend(), "data_rank_world": [dp.rank, dp.world],
           "model_rank_size": [mp.rank, mp.size]}

    # ---- train-tp
    lcfg, backbone, dcfg, decoder, batch, noun_dict = build_train_inputs(device, backbone_name)
    shard = shard_lavila(backbone, lcfg, mp)
    res["local_heads"] = block_routes(lcfg.visual, TRAIN_T, N, mp)["heads"]
    res["shard_qkv_rows"] = shard.visual.blocks[0].attn.qkv.weight.shape[0]
    f32 = TrainConfig(lr=TRAIN_LR, backbone_dtype=torch.float32)
    bf16 = replace(f32, backbone_dtype=torch.bfloat16)
    one = {}
    cuda = device.type == "cuda"
    feats, relus = {}, {}
    if rank == 0:  # the one-process references, outside the counted window
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        with _recording_features(feats.setdefault("one", [])), _relu_pattern(record=relus.setdefault("one", [])):
            one["f32"] = _tp_step(dcfg, lcfg, f32, decoder, backbone, batch, noun_dict, device)
        one["bf16"] = _tp_step(dcfg, lcfg, bf16, decoder, backbone, batch, noun_dict, device)
        res["one_process_step_ms"] = _steps_ms(*one["bf16"][3:], backbone, batch, noun_dict, TP_TIMED)
        res["one_process_peak_memory_gb"] = _peak_gb(device)
        # what the f32 comparison reads besides the split: the same step
        # again, and the step with the row-split sums made in halves here
        wm, wg = one["f32"][:2]
        again = _tp_step(dcfg, lcfg, f32, decoder, backbone, batch, noun_dict, device)
        res["f32_repeat_grad_worst"] = _grad_gap(again[1], wg)
        with _row_split_in_halves(backbone) as made, _recording_features(feats.setdefault("halves", [])):
            halves = _tp_step(dcfg, lcfg, f32, decoder, backbone, batch, noun_dict, device)
        res["halves_products"] = len(made)
        res["f32_halves_grad_worst"] = _grad_gap(halves[1], wg)
        res["f32_halves_rel_err"] = {k: abs(halves[0][k] - wm[k]) / max(abs(wm[k]), 1e-12) for k in wm}
        del again, halves
    del backbone
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    dist.barrier()
    # ---- the main path: counts set to 0 just before, read just after
    shapes = set()
    reset_counts()
    with _recording_attention_shapes(shapes):
        with _recording_features(feats.setdefault("split", [])):
            tp32 = _tp_step(dcfg, lcfg, f32, decoder, shard, batch, noun_dict, device, dp, mp)
        tp16 = _tp_step(dcfg, lcfg, bf16, decoder, shard, batch, noun_dict, device, dp, mp)
        res["step_ms"] = _steps_ms(*tp16[3:], shard, batch, noun_dict, TP_TIMED)
    if cuda:
        torch.cuda.synchronize(device)
    res["launches"] = read_counts()
    # ----
    res["steps_counted"] = 2 + TP_TIMED
    res["peak_memory_gb"] = _peak_gb(device)
    for name, run in (("f32", tp32), ("bf16", tp16)):  # the replicated decoders after the update
        copies = [torch.empty_like(run[2]) for _ in range(TP_RANKS)]
        dist.all_gather(copies, run[2])
        res[f"params_equal_on_every_rank_{name}"] = all(torch.equal(c, copies[0]) for c in copies)
    if rank == 0:
        wm, wg = one["f32"][:2]
        res["f32_metrics"], res["one_process_f32_metrics"] = tp32[0], wm
        res["f32_rel_err"] = {k: abs(tp32[0][k] - wm[k]) / max(abs(wm[k]), 1e-12) for k in wm}
        res["f32_grad_max_abs_err"] = max(float((tp32[1][n] - g).abs().max()) for n, g in wg.items())
        res["f32_grad_tol"] = 1e-4 * max(1.0, wm["grad_norm"])
        res["f32_grad_worst"] = _grad_gap(tp32[1], wg)
        res["f32_features_rel_err"] = _feature_gap(feats["split"], feats["one"])
        res["f32_halves_features_rel_err"] = _feature_gap(feats["halves"], feats["one"])
        res["bf16_rel_err"] = {k: abs(tp16[0][k] - one["bf16"][0][k]) / max(abs(one["bf16"][0][k]), 1e-12)
                               for k in one["bf16"][0]}
        # the decoder alone on the split's features: as it is (the split
        # step's gradients again), and with the one-process step's ReLU
        # pattern imposed (what is left without the units whose input lies
        # within rounding of zero)
        with _given_features(feats["split"][0], device), _relu_pattern(record=relus.setdefault("split", [])):
            replay = _tp_step(dcfg, lcfg, f32, decoder, None, batch, noun_dict, device)
        with _given_features(feats["split"][0], device), _relu_pattern(impose=relus["one"]):
            masked = _tp_step(dcfg, lcfg, f32, decoder, None, batch, noun_dict, device)
        res["f32_replay_grad_max_abs_err"] = _grad_gap(replay[1], tp32[1])["max_abs_err"]
        res["relu_units_flipped"] = [int((a != b).sum()) for a, b in zip(relus["one"], relus["split"])]
        res["f32_masked_grad_worst"] = _grad_gap(masked[1], wg)
        res["f32_masked_grad_tol"] = TP_MASKED_GRAD_RTOL * max(1.0, wm["grad_norm"])
        del replay, masked
        res["same_grad_names"] = set(tp32[1]) == set(wg) == set(tp16[1])
        g16, w16 = (torch.cat([g[n].reshape(-1) for n in sorted(g)]).double() for g in (tp16[1], one["bf16"][1]))
        res["bf16_grad_cosine"] = float(g16 @ w16 / (g16.norm() * w16.norm()))
        res["bf16_total_loss"] = {"split": tp16[0]["total_loss"], "one_process": one["bf16"][0]["total_loss"]}
    del tp32, tp16, one, shard, feats, relus
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    # ---- train-loop-tp: counts set to 0 just before, read just after
    argv = _loop_argv(meta, data, Path(out) / "runs", "tp", "--max_steps", str(LOOP_REF_STEPS), "--num_workers",
                      "1", "--model_parallel", str(TP_RANKS), "--device", device.type, "--backbone", backbone_name,
                      *_loop_sets(TP_LOOP_SET))
    t0 = time.perf_counter()
    with _egomcq_sims(Path(out) / f"sims_rank{rank}") as sims, _recording_attention_shapes(shapes):
        reset_counts()
        state, best = cli_train.main(argv)
        if cuda:
            torch.cuda.synchronize(device)
        res["loop"] = {"launches": read_counts(), "steps": state.step, "best": best, "sims": sims,
                       "seconds": time.perf_counter() - t0, "peak_memory_gb": _peak_gb(device)}
    # ----
    res["kernel_shapes"] = sorted(shapes)
    dist.destroy_process_group()
    Path(out, f"rank{rank}.json").write_text(json.dumps(res))


def _run_tp_workers(out: Path, fixture, device: str, backbone_name: str, timeout: float = 900) -> list[dict]:
    """Start the ``TP_RANKS`` ranks of ``tp_worker`` and wait for them;
    a rank that fails stops the others, and its log's tail is raised."""
    meta, data = fixture
    port = _free_port()
    logs = [open(out / f"rank{r}.log", "w") for r in range(TP_RANKS)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--tp-worker", str(r), str(port),
                               str(out), meta, data, device, backbone_name], stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(TP_RANKS)]
    try:
        deadline = time.time() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.time() > deadline:
                break
            time.sleep(1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tail = (out / f"rank{bad[0]}.log").read_text()[-3000:]
        raise AssertionError(f"train-tp: rank {bad[0]} of {TP_RANKS} failed (rc {procs[bad[0]].returncode}); "
                             f"its log ends:\n{tail}")
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(TP_RANKS)]


def phase_train_tp(card, root: Path, device="cuda", backbone_name="timesformer_large",
                   checked: set | None = None) -> dict:
    """"train-tp" and "train-loop-tp": the frozen TimeSformer-L + CLIP text
    tower split over ``TP_RANKS`` ``gloo`` ranks on the one card (model=2,
    data=1), each holding half of the heads and hidden units. "train-tp":
    "train"'s batch (16 clips, 4 frames), f32 with TF32 off against rank 0's
    one-process step (loss terms within rtol 1e-4, gradients within 1e-4 x
    max(1, grad_norm)), the updated parameters the same bits on both
    ranks, the bf16 kernel route's gradients within cosine 0.999 of the
    one-process bf16 step's, K1 and K2 24 times a step on 8 heads a rank.
    "train-loop-tp": ``cli.train.main --model_parallel 2`` for 3 steps on
    the loop's fixture cut to 48 rows and ``TP_MCQ`` EgoMCQ items (the
    split forwards move their activations through host memory),
    ``--num_workers 1``, the backbone in f32
    (``TP_LOOP_SET``), against the same loop in one process first: the
    logged losses within rtol 1e-4; the online EgoMCQ on both ranks, in
    bf16 as the loop's ``EvalModel`` runs it: each rank's similarity rows
    within ``TP_SIM_ATOL`` of the one-process run's, and the same clip
    picked for every item but where the one-process run's two best clips
    are closer than twice the largest difference (the accuracies are
    printed beside). -> launches of the main paths: the one-process loop
    and both ranks'."""
    from types import SimpleNamespace

    from helping_hand_for_egocentric_videos_torch.models import lavila

    out = root / "tp"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    lcfg = getattr(lavila, f"{backbone_name}_config")(TRAIN_T)
    fixture = meta, data = write_egoclip_fixture(out / "egoclip", rows=LOOP_ITEMS * LOOP_REF_STEPS, mcq=TP_MCQ,
                                                 noun_width=lcfg.text.width)
    small = [] if backbone_name == "timesformer_large" else ["--device", device, "--backbone", backbone_name]
    with _egomcq_sims(out / "sims_one") as ref_sims:
        ref = _run_loop(_loop_argv(meta, data, out / "runs", "one", "--max_steps", str(LOOP_REF_STEPS),
                                   "--num_workers", "1", *small, *_loop_sets(TP_LOOP_SET)))
    ref_losses, ref_val = _losses(ref["train"]), ref["val"]
    t0 = time.perf_counter()
    ranks = _run_tp_workers(out, fixture, device, backbone_name)
    seconds = time.perf_counter() - t0
    per_step = launches_per_forward(SimpleNamespace(lavila_cfg=lcfg, int8=False))
    r0 = ranks[0]
    step_launches_ok = all(r["launches"] == {k: v * r["steps_counted"] for k, v in per_step.items()} for r in ranks)
    res = {"card": card, "backend": [r["backend"] for r in ranks], "ranks": TP_RANKS, "B": TRAIN_B, "T": TRAIN_T,
           "model_rank_size": [r["model_rank_size"] for r in ranks],
           "data_rank_world": [r["data_rank_world"] for r in ranks], "local_heads": [r["local_heads"] for r in ranks],
           "shard_qkv_rows": [r["shard_qkv_rows"] for r in ranks],
           "f32_rel_err": r0["f32_rel_err"], "rtol": 1e-4, "f32_grad_max_abs_err": r0["f32_grad_max_abs_err"],
           "f32_grad_tol": r0["f32_grad_tol"], "f32_grad_worst": r0["f32_grad_worst"],
           "f32_repeat_grad_worst": r0["f32_repeat_grad_worst"], "f32_halves_grad_worst": r0["f32_halves_grad_worst"],
           "f32_halves_rel_err": r0["f32_halves_rel_err"], "halves_products": r0["halves_products"],
           "f32_features_rel_err": r0["f32_features_rel_err"], "features_rtol": TP_FEATURE_RTOL,
           "f32_halves_features_rel_err": r0["f32_halves_features_rel_err"],
           "f32_replay_grad_max_abs_err": r0["f32_replay_grad_max_abs_err"],
           "relu_units_flipped": r0["relu_units_flipped"], "f32_masked_grad_worst": r0["f32_masked_grad_worst"],
           "f32_masked_grad_tol": r0["f32_masked_grad_tol"],
           "same_grad_names": r0["same_grad_names"],
           "params_equal_on_every_rank": {k: [r[f"params_equal_on_every_rank_{k}"] for r in ranks]
                                          for k in ("f32", "bf16")},
           "bf16_grad_cosine": r0["bf16_grad_cosine"], "bf16_grad_cosine_limit": TP_GRAD_COS,
           "bf16_total_loss": r0["bf16_total_loss"],
           "bf16_rel_err": {k: r0["bf16_rel_err"][k] for k in TP_LOSSES}, "bf16_rtol": TP_BF16_LOSS_RTOL,
           "kernel_shapes": sorted({tuple(x) for r in ranks for x in r["kernel_shapes"]}),
           "f32_metrics": r0["f32_metrics"],
           "one_process_f32_metrics": r0["one_process_f32_metrics"],
           "launches": [r["launches"] for r in ranks], "launches_per_step": per_step,
           "steps_counted": r0["steps_counted"],
           "step_ms": [r["step_ms"] for r in ranks], "one_process_step_ms": r0["one_process_step_ms"],
           "peak_memory_gb": [r["peak_memory_gb"] for r in ranks],
           "one_process_peak_memory_gb": r0["one_process_peak_memory_gb"], "timed_steps": TP_TIMED,
           "phase_seconds": seconds}
    res["unchecked_kernel_shapes"] = None if checked is None else [x for x in res["kernel_shapes"]
                                                                   if tuple(x[:4]) not in checked]
    say("train-tp", **res)
    if res["unchecked_kernel_shapes"]:
        raise AssertionError(f"train-tp: K1/K2 launched at (mode, H, B, T, dtype) never held against the plain "
                             f"version: {res['unchecked_kernel_shapes']}")
    ok = (max(res["f32_rel_err"].values()) <= 1e-4 and res["f32_grad_max_abs_err"] <= res["f32_grad_tol"]
          and max(res["f32_features_rel_err"].values()) <= TP_FEATURE_RTOL
          and res["f32_masked_grad_worst"]["max_abs_err"] <= res["f32_masked_grad_tol"]
          and max(res["bf16_rel_err"].values()) <= TP_BF16_LOSS_RTOL
          and res["same_grad_names"] and all(all(v) for v in res["params_equal_on_every_rank"].values())
          and res["bf16_grad_cosine"] >= TP_GRAD_COS and step_launches_ok
          and res["local_heads"] == [lcfg.visual.heads // TP_RANKS] * TP_RANKS
          and all(b == "gloo" for b in res["backend"]))
    if not ok:
        raise AssertionError("the split step disagrees with the one-process step or launched otherwise (train-tp line)")

    exp = out / "runs" / "tp"
    losses = _losses(_jsonl(exp / "train_metrics.jsonl"))
    val = _jsonl(exp / "val_metrics.jsonl")
    rel = {s: abs(losses[s] - ref_losses[s]) / abs(ref_losses[s]) for s in ref_losses if s in losses}

    def accs(rows):
        return [{k: v for k, v in r.items() if k != "time"} for r in rows]

    evals = [{"egomcq/n_items": r["egomcq/n_items"]} for r in val]
    want = {k: v * (LOOP_REF_STEPS + sum(-(-int(r["egomcq/n_items"]) // LOOP_EVAL_ITEMS_PER_FORWARD) for r in evals))
            for k, v in per_step.items()}
    agree = [_egomcq_agree(r["loop"]["sims"][-1], ref_sims[-1]) for r in ranks]
    loop = {"card": card, "ranks": TP_RANKS, "steps": [r["loop"]["steps"] for r in ranks], "total_loss": losses,
            "one_process_total_loss": ref_losses, "rel_err": rel, "rtol": 1e-4, "val": accs(val),
            "one_process_val": accs(ref_val), "accuracies_equal": accs(val) == accs(ref_val), "egomcq": agree,
            "evals_a_rank": [len(r["loop"]["sims"]) for r in ranks], "best": [r["loop"]["best"] for r in ranks],
            "launches": [r["loop"]["launches"] for r in ranks], "launches_expected_each_rank": want,
            "seconds": [r["loop"]["seconds"] for r in ranks],
            "peak_memory_gb": [r["loop"]["peak_memory_gb"] for r in ranks]}
    say("train-loop-tp", **loop)
    if not (sorted(rel) == list(range(1, LOOP_REF_STEPS + 1)) and max(rel.values()) <= 1e-4
            and all(a["ok"] for a in agree) and loop["evals_a_rank"] == [len(ref_sims)] * TP_RANKS
            and loop["steps"] == [LOOP_REF_STEPS] * TP_RANKS and all(x == want for x in loop["launches"])
            and len(set(loop["best"])) == 1):
        raise AssertionError("the loop with a split backbone disagrees with the one-process loop (train-loop-tp line)")
    return {k: ref["launches"][k] + sum(r["launches"][k] + r["loop"]["launches"][k] for r in ranks) for k in counters()}


# ---------------------------------------------------------------- the eval harnesses
EVAL_MCQ, EVAL_MCQ_PER_FORWARD, EVAL_MCQ_T = 40, 4, 4  # items; items a forward (5 clips each); frames
EPIC_CLIPS, EPIC_VIDEOS, EPIC_FRAMES, EPIC_HW, EPIC_T, EPIC_BATCH = 64, 3, 150, (256, 456), 16, 8
EGTEA_HW, EGTEA_CLIPS, EGTEA_T, EGTEA_STRIDE = (256, 342), 10, 16, 2
# frames of the 8 split-1 videos; 20, 28 and 31 < 16 x 2 are zero-padded to one window
EGTEA_LENGTHS = (20, 96, 28, 64, 120, 31, 48, 75)
EGTEA_F32_VIDEOS = 2  # the f32 comparison's videos, a padded one first
EGTEA_LABELS = 106
SIM_ATOL = 1e-3  # f32 kernel route vs f32 plain attention, raw similarity matrices
EPIC_VERBS = ("take", "put", "open", "close", "wash", "cut", "pour", "turn-on")
EPIC_NOUNS = ("plate", "knife", "fridge", "tap", "onion", "drawer", "pan", "cup")


def write_epic_fixture(root: Path) -> tuple[str, str]:
    """A synthetic EPIC-100 retrieval layout under ``root`` -> (meta_dir,
    data_dir): ``EPIC_VIDEOS`` videos of ``EPIC_FRAMES`` seeded 256 x 456
    frames as ``<participant>/<video>.MP4.npy`` sidecars, ``EPIC_CLIPS``
    narrated clips of 0.5-2 s over them, the sentence list, a seeded
    (clips, clips) relevancy matrix of graded values in [0, 1] with a 1 in
    every row (not the identity), a permuted ``indexes.pkl`` and
    ``fps_dict_256.pth`` at 30 fps."""
    import pickle

    import torch

    rng = np.random.default_rng(SEED + 21)
    meta, data = root / "meta", root / "data"
    (meta / "retrieval_annotations").mkdir(parents=True, exist_ok=True)
    (meta / "relevancy").mkdir(exist_ok=True)
    videos = [(f"P0{i + 1}", f"P0{i + 1}_0{i + 1}") for i in range(EPIC_VIDEOS)]
    fps = {}
    for pid, vid in videos:
        (data / pid).mkdir(parents=True, exist_ok=True)
        np.save(data / pid / f"{vid}.MP4.npy",
                rng.integers(0, 256, size=(EPIC_FRAMES, *EPIC_HW, 3), dtype=np.uint8))
        fps[os.path.join(str(data), pid, f"{vid}.MP4")] = 30.0
    torch.save(fps, meta / "fps_dict_256.pth")

    def stamp(sec):
        return f"00:00:{sec:05.2f}"

    header = ("narration_id,participant_id,video_id,narration_timestamp,start_timestamp,stop_timestamp,"
              "start_frame,stop_frame,narration")
    rows, sentences = [header], ["narration_id,sentence"]
    for i in range(EPIC_CLIPS):
        pid, vid = videos[i % EPIC_VIDEOS]
        start = round(float(rng.uniform(0, EPIC_FRAMES / 30 - 2.1)), 2)
        stop = round(start + float(rng.uniform(0.5, 2.0)), 2)
        text = f"{EPIC_VERBS[i % 8]} {EPIC_NOUNS[(i // 8) % 8]}"
        rows.append(f"{vid}_{i},{pid},{vid},{stamp(start)},{stamp(start)},{stamp(stop)},"
                    f"{int(start * 30)},{int(stop * 30)},{text}")
        sentences.append(f"{vid}_{i},{text}")
    (meta / "retrieval_annotations" / "EPIC_100_retrieval_test.csv").write_text("\n".join(rows) + "\n")
    (meta / "retrieval_annotations" / "EPIC_100_retrieval_test_sentence.csv").write_text("\n".join(sentences) + "\n")
    rel = np.round(rng.random((EPIC_CLIPS, EPIC_CLIPS)), 2) * (rng.random((EPIC_CLIPS, EPIC_CLIPS)) < 0.3)
    rel[np.arange(EPIC_CLIPS), rng.permutation(EPIC_CLIPS)] = 1.0
    with open(meta / "relevancy" / "caption_relevancy_EPIC_100_retrieval_test.pkl", "wb") as f:
        pickle.dump(rel.astype(np.float32), f)
    with open(meta / "indexes.pkl", "wb") as f:
        pickle.dump(rng.permutation(EPIC_CLIPS), f)
    return str(meta), str(data)


def write_egtea_fixture(root: Path) -> tuple[str, str]:
    """A synthetic EGTEA Gaze+ layout under ``root`` -> (meta_dir,
    data_dir): the 106 action labels (``action_idx.txt``), a split-1 file
    of ``len(EGTEA_LENGTHS)`` trimmed clips of seeded 256 x 342 frames as
    ``<video>/<clip>.mp4.npy`` (some shorter than 16 x 2 frames, so the
    dataset pads them), and ``egtea_video_list.pth.tar`` with their
    lengths."""
    import torch

    rng = np.random.default_rng(SEED + 22)
    meta, data = root / "meta", root / "data"
    meta.mkdir(parents=True, exist_ok=True)
    verbs = ("Open", "Close", "Take", "Put", "Cut", "Wash", "Pour", "Turn_on", "Move")
    nouns = ("Drawer", "Fridge", "Plate", "Knife", "Onion", "Bowl", "Pan", "Cup", "Tomato", "Lettuce", "Oil",
             "Faucet")
    names = [f"{v}_{n}" for v in verbs for n in nouns][:EGTEA_LABELS]
    (meta / "action_idx.txt").write_text("".join(f"{n} {i + 1}\n" for i, n in enumerate(names)))
    lines, len_dict = [], {}
    for i, n in enumerate(EGTEA_LENGTHS):
        video = f"OP0{i % 4 + 1}-R0{i % 3 + 1}-PastaSalad"
        clip = f"{video}-{1000 + i}"
        (data / video).mkdir(parents=True, exist_ok=True)
        np.save(data / video / f"{clip}.mp4.npy", rng.integers(0, 256, size=(n, *EGTEA_HW, 3), dtype=np.uint8))
        len_dict[os.path.join(str(data), video, f"{clip}.mp4")] = n
        lines.append(f"{clip} {int(rng.integers(1, EGTEA_LABELS + 1))} 0 0")
    (meta / "test_split1.txt").write_text("\n".join(lines) + "\n")
    torch.save({"len_dict": len_dict}, meta / "egtea_video_list.pth.tar")
    return str(meta), str(data)


class HarnessProbe:
    """Observes one run of an eval CLI or harness without changing it: the
    ``EvalModel`` that ``cli.common.build_eval_model`` returns (each of its
    ``embed_video`` calls recorded: the embeddings, as rows, and the model
    that made them), every cosine matrix the harness takes
    (``train.evaluate._cos``), the wall time of the harness call
    (``harness``, data decode included; None: no harness) and the time it
    spent waiting for the next decoded item (``_prefetch_items``)."""

    def __init__(self, harness: str | None):
        self.harness = harness
        self.model, self.embeddings, self.forward_models, self.sims = None, [], [], []
        self.seconds = self.wait_s = 0.0

    def watch(self, model):
        real = model.embed_video

        def embed_video(video_u8):
            emb, boxes = real(video_u8)
            self.embeddings.append(emb)
            self.forward_models.append(model)
            return emb, boxes

        model.embed_video = embed_video
        return model

    def __enter__(self):
        from helping_hand_for_egocentric_videos_torch.cli import common
        from helping_hand_for_egocentric_videos_torch.train import evaluate

        self._saved = [(common, "build_eval_model"), (evaluate, self.harness or "_cos"), (evaluate, "_cos"),
                       (evaluate, "_prefetch_items")]
        self._saved = [(mod, name, getattr(mod, name)) for mod, name in self._saved]
        build, harness, cos, prefetch = (f for _, _, f in self._saved)

        def build_eval_model(args):
            model, lcfg, dcfg = build(args)
            self.model = self.watch(model)
            return model, lcfg, dcfg

        def timed_harness(*a, **kw):
            t0 = time.perf_counter()
            try:
                return harness(*a, **kw)
            finally:
                self.seconds += time.perf_counter() - t0

        def recorded_cos(a, b):
            self.sims.append(cos(a, b))
            return self.sims[-1]

        def timed_prefetch(dataset, n, depth=16):
            gen = prefetch(dataset, n, depth)
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        item = next(gen)
                    except StopIteration:
                        return
                    finally:
                        self.wait_s += time.perf_counter() - t0
                    yield item
            finally:
                gen.close()

        common.build_eval_model = build_eval_model
        if self.harness:
            setattr(evaluate, self.harness, timed_harness)
        evaluate._cos = recorded_cos
        evaluate._prefetch_items = timed_prefetch
        return self

    def __exit__(self, *exc):
        for mod, name, f in reversed(self._saved):
            setattr(mod, name, f)

    def rows(self) -> np.ndarray:
        return np.concatenate(self.embeddings)


def _eval_cli(module, argv, harness: str | None, card) -> dict:
    """``module.main(argv)`` with the launch counts set to 0 just before and
    read just after, under a ``HarnessProbe``. Each video forward must
    launch what ``launches_per_forward`` says for the model that ran it.
    -> the run: what ``main`` returned, its ``--out`` results, launches,
    forwards, rows embedded, harness seconds, clips/s, data-wait share,
    peak memory, and the probe (model, embeddings, similarities)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with HarnessProbe(harness) as probe:
        # ---- the main path: counts set to 0 just before, read just after
        reset_counts()
        returned = module.main(argv)
        torch.cuda.synchronize()
        launches = read_counts()
        # ----
    forwards, rows = len(probe.embeddings), int(sum(len(e) for e in probe.embeddings))
    want = dict.fromkeys(counters(), 0)
    for m in probe.forward_models:
        for k, v in launches_per_forward(m).items():
            want[k] += v
    if forwards < 1 or launches != want:
        raise AssertionError(f"{launches} launches for {forwards} forwards, want {want}")
    run = {"returned": returned, "launches": launches, "forwards": forwards, "rows": rows,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card, "probe": probe}
    if "--out" in argv:
        run["results"] = json.loads(Path(argv[argv.index("--out") + 1]).read_text())
    if harness:
        run.update(harness_seconds=probe.seconds, clips_per_s=rows / probe.seconds,
                   data_wait_share=probe.wait_s / probe.seconds)
    return run


def _summary(run: dict) -> dict:
    return {k: v for k, v in run.items() if k not in ("probe", "returned")}


def _f32_models(model):
    """The f32 kernel route and the f32 plain attention on ``model``'s
    weights and preprocessing: (kernel, plain)."""
    import torch

    from helping_hand_for_egocentric_videos_torch.train import EvalModel

    lcfg = model.lavila_cfg
    plain_cfg = replace(lcfg, visual=replace(lcfg.visual, attention_backend="reference"))
    kw = dict(input_res=model.input_res, preprocess=model.preprocess, dtype=torch.float32, device=model.device)
    return (EvalModel(model.backbone, lcfg, model.decoder, model.dec_cfg, model.tokenizer, **kw),
            EvalModel(model.backbone, plain_cfg, model.decoder, model.dec_cfg, model.tokenizer, **kw))


def _kernel_vs_plain_harness(model, harness: str, call, bf16_rows: np.ndarray) -> dict:
    """``call(m)`` runs the harness on model m: with the f32 kernel route and
    with the f32 plain attention on ``model``'s weights, every similarity
    matrix the harness takes within ``SIM_ATOL`` absolute; ``bf16_rows``
    (the bf16 kernel route's embeddings of the same clips, in order) against
    the f32 plain ones with a cosine of at least 0.99 a row."""
    import torch

    k32, p32 = _f32_models(model)
    res = {}
    for name, m in (("kernel", k32), ("plain", p32)):
        with HarnessProbe(harness) as probe:
            probe.watch(m)
            res[name] = call(m)
        res[name + "_probe"] = probe
    del k32, p32
    torch.cuda.empty_cache()
    ks, ps = res["kernel_probe"].sims, res["plain_probe"].sims
    diff = max(float(np.abs(a - b).max()) for a, b in zip(ks, ps)) if len(ks) == len(ps) else np.inf
    plain_rows = res["plain_probe"].rows()
    cos = _cosine(bf16_rows[:len(plain_rows)], plain_rows)
    check = {"f32_sims_max_abs_diff": diff, "sims_limit": SIM_ATOL, "sim_matrices": len(ks),
             "f32_kernel_results": res["kernel"], "f32_plain_results": res["plain"],
             "bf16_vs_f32_plain_min_cosine": float(cos.min()), "rows_compared": len(cos), "cosine_limit": 0.99}
    if not (np.isfinite(plain_rows).all() and diff <= SIM_ATOL):
        raise AssertionError(f"{harness}: f32 kernel route vs f32 plain similarities differ by {diff} > {SIM_ATOL}")
    if not (cos >= 0.99).all():
        raise AssertionError(f"{harness}: bf16 kernel route vs f32 plain, cosine {cos.min()} < 0.99")
    return check


def _in_range(results: dict, keys, lo, hi) -> bool:
    return set(keys) <= set(results) and all(np.isfinite(results[k]) and lo <= results[k] <= hi for k in keys)


def _eval_argv(ckpts, meta, data, out, backbone, device, *extra):
    return ["--meta_dir", meta, "--data_dir", data, "--backbone", backbone, "--backbone_ckpt", ckpts[0],
            "--decoder_ckpt", ckpts[1], "--device", device, "--out", str(out), *extra]


def phase_eval_egomcq(card, ckpts, root: Path, device="cuda", backbone="timesformer_large"):
    """"eval-egomcq": ``cli.test_egomcq.main`` on ``write_egoclip_fixture``'s
    40 EgoMCQ items (4 frames, 5 clips an item, 4 items = 20 clips a
    forward) from the reference-layout checkpoints. -> launches."""
    from helping_hand_for_egocentric_videos_torch.cli import test_egomcq
    from helping_hand_for_egocentric_videos_torch.data.egoclip import EgoClipConfig, EgoClipDataset
    from helping_hand_for_egocentric_videos_torch.train import evaluate

    meta, data = write_egoclip_fixture(root / "egoclip", rows=16, mcq=EVAL_MCQ)
    argv = _eval_argv(ckpts, meta, data, root / "egomcq.json", backbone, device, "--out_sims",
                      str(root / "egomcq_sims.npz"))
    run = _eval_cli(test_egomcq, argv, "run_egomcq", card)
    res = run["results"]
    ok = (_in_range(res, ("Inter-video", "Intra-video"), 0, 100) and res["n_items"] == EVAL_MCQ
          and run["forwards"] == -(-EVAL_MCQ // EVAL_MCQ_PER_FORWARD) and run["rows"] == 5 * EVAL_MCQ)
    strict = EgoClipDataset(EgoClipConfig(meta_dir=meta, data_dir=data, split="val", num_frames=EVAL_MCQ_T,
                                          loading="strict"))
    check = _kernel_vs_plain_harness(run["probe"].model, "run_egomcq", lambda m: evaluate.run_egomcq(m, strict),
                                     run["probe"].rows())
    say("eval-egomcq", **_summary(run), frames=EVAL_MCQ_T, clips_per_forward=5 * EVAL_MCQ_PER_FORWARD, **check)
    if not ok:
        raise AssertionError(f"eval-egomcq: bad results or forwards: {_summary(run)}")
    return run["launches"]


def phase_eval_epic(card, ckpts, root: Path, device="cuda", backbone="timesformer_large"):
    """"eval-epic": ``cli.test_epic.main`` on ``write_epic_fixture``'s layout
    at 16 frames, ``--batch_size 8``, once in bf16 and once with ``--int8``
    (the int8 embeddings against the bf16 ones with a cosine of at least
    ``INT8_COS_FLOOR`` a clip). -> (launches of both runs, the layout's
    (meta_dir, data_dir), the bf16 run's metrics)."""
    import pickle

    from helping_hand_for_egocentric_videos_torch.cli import test_epic
    from helping_hand_for_egocentric_videos_torch.data.epic import EpicConfig, EpicMIRDataset
    from helping_hand_for_egocentric_videos_torch.train import evaluate

    meta, data = write_epic_fixture(root / "epic")
    runs = {}
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        argv = _eval_argv(ckpts, meta, data, root / f"epic_{tag}.json", backbone, device, "--num_frames",
                          str(EPIC_T), "--batch_size", str(EPIC_BATCH), "--out_sims", str(root / f"epic_{tag}.npz"),
                          *(["--int8"] if int8 else []))
        runs[tag] = _eval_cli(test_epic, argv, "run_epic_mir", card)
    keys = ("nDCG_VT", "nDCG_TV", "nDCG_AVG", "mAP_VT", "mAP_TV", "mAP_AVG")
    ok = all(_in_range(r["results"], keys, 0, 1 + 1e-6) and r["forwards"] == -(-EPIC_CLIPS // EPIC_BATCH)
             and r["rows"] == EPIC_CLIPS for r in runs.values())
    cos8 = _cosine(runs["int8"]["probe"].rows(), runs["bf16"]["probe"].rows())
    del runs["int8"]["probe"]
    with open(Path(meta) / "relevancy" / "caption_relevancy_EPIC_100_retrieval_test.pkl", "rb") as f:
        relevancy = pickle.load(f)
    with open(Path(meta) / "indexes.pkl", "rb") as f:
        indexes = np.asarray(pickle.load(f))
    strict = EpicMIRDataset(EpicConfig(meta_dir=meta, data_dir=data, num_frames=EPIC_T, loading="strict"))
    bf16 = runs["bf16"]
    check = _kernel_vs_plain_harness(bf16["probe"].model, "run_epic_mir",
                                     lambda m: evaluate.run_epic_mir(m, strict, relevancy, indexes,
                                                                     batch_size=EPIC_BATCH), bf16["probe"].rows())
    say("eval-epic", frames=EPIC_T, clips=EPIC_CLIPS, bf16=_summary(bf16), int8=_summary(runs["int8"]),
        int8_vs_bf16_min_cosine=float(cos8.min()), int8_cosine_limit=INT8_COS_FLOOR, **check)
    if not ok:
        raise AssertionError("eval-epic: bad results or forwards (eval-epic line)")
    if not (cos8 >= INT8_COS_FLOOR).all():
        raise AssertionError(f"eval-epic: int8 vs bf16 embeddings, cosine {cos8.min()} < {INT8_COS_FLOOR}")
    launches = {k: bf16["launches"][k] + runs["int8"]["launches"][k] for k in counters()}
    return launches, (meta, data), bf16["results"]


def phase_eval_egtea(card, ckpts, root: Path, device="cuda", backbone="timesformer_large"):
    """"eval-egtea": ``cli.test_egtea.main`` on ``write_egtea_fixture``'s
    split 1, 10 clips of 16 frames at stride 2, with ``--spatial_crops 1``
    (10 clips a forward) and then ``--spatial_crops 6`` (60). The f32
    comparison runs the 6-crop model on the first ``EGTEA_F32_VIDEOS``
    videos (a padded one first). -> launches of both runs."""
    from helping_hand_for_egocentric_videos_torch.cli import test_egtea
    from helping_hand_for_egocentric_videos_torch.data.egtea import EgteaConfig, EgteaDataset, generate_label_map
    from helping_hand_for_egocentric_videos_torch.train import evaluate

    meta, data = write_egtea_fixture(root / "egtea")
    runs = {}
    for crops in (1, 6):
        argv = _eval_argv(ckpts, meta, data, root / f"egtea_{crops}.json", backbone, device, "--num_frames",
                          str(EGTEA_T), "--num_clips", str(EGTEA_CLIPS), "--clip_stride", str(EGTEA_STRIDE),
                          "--splits", "1", "--spatial_crops", str(crops))
        runs[crops] = _eval_cli(test_egtea, argv, "run_egtea", card)
    n = len(EGTEA_LENGTHS)
    ok = all(_in_range(r["results"], ("mean_class_acc", "top1"), 0, 100) and r["forwards"] == n
             and r["rows"] == n * EGTEA_CLIPS * crops for crops, r in runs.items())
    labels, _ = generate_label_map(os.path.join(meta, "action_idx.txt"))
    ds = EgteaDataset(EgteaConfig(root=data, metadata=os.path.join(meta, "test_split1.txt"), anno_dir=meta,
                                  num_clips=EGTEA_CLIPS, clip_length=EGTEA_T, clip_stride=EGTEA_STRIDE))
    ds.samples = ds.samples[:EGTEA_F32_VIDEOS]
    six = runs[6]
    check = _kernel_vs_plain_harness(six["probe"].model, "run_egtea", lambda m: evaluate.run_egtea(m, ds, labels),
                                     six["probe"].rows())
    del runs[1]["probe"]
    say("eval-egtea", frames=EGTEA_T, videos=n, video_frames=list(EGTEA_LENGTHS), labels=len(labels),
        crops1=_summary(runs[1]), crops6=_summary(six), f32_videos=EGTEA_F32_VIDEOS, **check)
    if not ok:
        raise AssertionError("eval-egtea: bad results or forwards (eval-egtea line)")
    return {k: runs[1]["launches"][k] + six["launches"][k] for k in counters()}


def phase_eval_tools(card, ckpts, epic, epic_results: dict, root: Path, device="cuda",
                     backbone="timesformer_large"):
    """"eval-tools": ``cli.extract_features.main`` over the EPIC layout's
    videos (16-frame windows every 0.5 s, 8 a forward: one ``.features.npz``
    a video, features finite, the windows ``iter_windows`` gives), then
    ``cli.parity_check.main`` on that layout with ``--int8_diff`` and a
    target table of "eval-epic"'s bf16 metrics at ``--tol 0.01``: the same
    weights and data must give the same metrics (every target passes), the
    int8 rank-stability figures must be there (random weights may leave
    near-ties, so their verdict is printed, not required), ``certified``
    must follow from both, and the report must name the backend and the
    card. -> launches of both runs."""
    import torch

    from helping_hand_for_egocentric_videos_torch.cli import extract_features, parity_check
    from helping_hand_for_egocentric_videos_torch.data.video import _maybe_npy

    meta, data = epic
    model_args = ["--backbone", backbone, "--backbone_ckpt", ckpts[0], "--decoder_ckpt", ckpts[1], "--device", device]
    feats = root / "features"
    fx = _eval_cli(extract_features, [*model_args, "--data_dir", data, "--out_dir", str(feats), "--pattern",
                                      "**/*.MP4*", "--num_frames", str(EPIC_T), "--stride_sec", "0.5"], None, card)
    files = sorted(feats.glob("*.features.npz"))
    windows = []
    for f in files:
        z = np.load(f)
        want = extract_features.iter_windows(len(_maybe_npy(str(z["path"]))), 30.0, EPIC_T, 0.5)
        windows.append(len(want))
        if not (z["features"].shape == (len(want), 256) and np.isfinite(z["features"]).all()
                and np.allclose(z["starts"], np.asarray(want, np.float32) / 30.0)):
            raise AssertionError(f"eval-tools: bad features in {f.name}: {z['features'].shape}")
    if len(files) != EPIC_VIDEOS or fx["rows"] != sum(windows):
        raise AssertionError(f"eval-tools: {len(files)} feature files of {fx['rows']} windows")
    targets = root / "targets.json"
    targets.write_text(json.dumps({f"epic.{k}": v for k, v in epic_results.items()}))
    rep = _eval_cli(parity_check, [*model_args, "--epic_meta", meta, "--epic_data", data, "--int8_diff", "--targets",
                                   str(targets), "--tol", "0.01", "--out_dir", str(root / "parity")], None, card)
    report = rep["returned"]
    name = torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu"
    gate, agree = report["gate"], report["int8_agreement"].get("epic", {})
    ok = (report["backend"] == "torch" and report["device"] == name
          and set(gate) == {f"epic.{k}" for k in epic_results} and all(g["pass"] for g in gate.values())
          and np.isfinite([agree.get("argmax_agreement", np.nan), agree.get("spearman", np.nan)]).all()
          and report["certified"] is agree["pass"] and rep["forwards"] == 2 * -(-EPIC_CLIPS // EPIC_BATCH))
    say("eval-tools", extract_features={**_summary(fx), "files": len(files), "windows": windows},
        parity_check={**_summary(rep), "gate": report["gate"], "int8_agreement": report["int8_agreement"],
                      "certified": report["certified"], "device": report["device"]})
    if not ok:
        raise AssertionError("eval-tools: parity_check's report is not what the same weights and data give")
    return {k: fx["launches"][k] + rep["launches"][k] for k in counters()}


# ---------------------------------------------------------------- the rest of the single-card surface
VIS_T, VIS_FRAMES, VIS_HW = 4, 60, (256, 342)  # cli.visualize's frames; the clip: 2 s at 30 fps
BOOT_ITEMS, BOOT_STEPS = 8, 3  # 8 items and their negatives: the "train" phase's 16 clips a step
ZOO_B = 32  # images a timed encode
MAP_ATOL, MAP_COS = 1e-4, 0.99  # f32 kernel vs f32 plain maps; bf16 kernel vs f32 plain, a query's row


def phase_visualize(card, ckpts, root: Path, device="cuda", backbone="timesformer_large"):
    """"visualize": ``cli.visualize.main`` with ``--attn`` at full width (4
    frames, the 13-query decoder with its trajectory head) from the
    reference-layout checkpoints, on a synthetic 256 x 342 ``.npy`` clip:
    both PNGs at their shapes, the boxes in [0, res], the last layer's
    cross-attention rows summing to 1 within 1e-3, K1 and K2 48 times each
    (the boxes' forward and the ``--attn`` forward); then the maps of the
    same frames through the f32 kernel route and the f32 plain attention
    within ``MAP_ATOL``, and the CLI's bf16 maps against the f32 plain ones
    with a cosine of at least ``MAP_COS`` a query. -> launches."""
    import torch
    from PIL import Image

    from helping_hand_for_egocentric_videos_torch.cli import visualize
    from helping_hand_for_egocentric_videos_torch.data.video import read_clip_chunked

    clip = root / "vis_clip.mp4.npy"
    np.save(clip, np.random.default_rng(SEED + 30).integers(0, 256, size=(VIS_FRAMES, *VIS_HW, 3), dtype=np.uint8))
    argv = ["--clip", str(clip), "--backbone", backbone, "--backbone_ckpt", ckpts[0], "--decoder_ckpt", ckpts[1],
            "--device", device, "--out_dir", str(root / "vis"), "--attn"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with HarnessProbe(None) as probe:
        # ---- the main path: counts set to 0 just before, read just after
        reset_counts()
        res = visualize.main(argv)
        torch.cuda.synchronize()
        launches = read_counts()
        # ----
    seconds = time.perf_counter() - t0
    model = probe.model
    want = {k: 2 * v for k, v in launches_per_forward(model).items()}  # the boxes' forward, the --attn forward
    px, nq = model.input_res, model.dec_cfg.num_queries
    side = int(model.lavila_cfg.visual.patches_per_frame ** 0.5)
    shapes = {"boxes.png": np.asarray(Image.open(res["boxes_png"])).shape,
              "cross_attn.png": np.asarray(Image.open(res["cross_attn_png"])).shape}
    attn, boxes = res["cross_attn"], res["boxes"]
    row_err = float(np.abs(attn.sum(-1) - 1).max())

    frames, _ = read_clip_chunked(str(clip), 0.0, 2.0, clip_length=VIS_T)
    k32, p32 = _f32_models(model)
    maps = [visualize.cross_attention_maps(m, frames, dtype=torch.float32).cpu().numpy() for m in (k32, p32)]
    del k32, p32, model, probe
    torch.cuda.empty_cache()
    f32_err = float(np.abs(maps[0] - maps[1]).max())
    cos = _cosine(attn, maps[1])
    check = {"card": card, "seconds": seconds, "launches": launches, "launches_expected": want, "png_shapes": shapes,
             "boxes_range": [float(boxes.min()), float(boxes.max())], "cross_attn_shape": list(attn.shape),
             "row_sum_max_err": row_err, "f32_kernel_vs_plain_max_abs": f32_err, "f32_limit": MAP_ATOL,
             "f32_map_max": float(maps[1].max()), "bf16_vs_f32_plain_min_cosine": float(cos.min()),
             "cosine_limit": MAP_COS}
    say("visualize", **check)
    ok = (launches == want and shapes == {"boxes.png": (px, VIS_T * px, 3),
                                          "cross_attn.png": (nq * side * 8, VIS_T * side * 8)}
          and boxes.shape == (VIS_T, nq, 4) and 0 <= boxes.min() and boxes.max() <= px
          and attn.shape == (nq, VIS_T * side * side) and np.isfinite(attn).all() and row_err <= 1e-3
          and f32_err <= MAP_ATOL and (cos >= MAP_COS).all())
    if not ok:
        raise AssertionError("visualize: bad images, maps or launches (visualize line)")
    return launches


# the port's CLIP modules' state-dict names -> OpenAI's (the reference's model/openai_model.py)
_CLIP_BLOCK_NAMES = ((r"^blocks\.", "transformer.resblocks."), (r"\.mlp_fc\.", ".mlp.c_fc."),
                     (r"\.mlp_proj\.", ".mlp.c_proj."))
_CLIP_RESNET_NAMES = ((r"\.downsample\.conv\.", ".downsample.0."), (r"\.downsample\.bn\.", ".downsample.1."),
                      (r"^attnpool\.([qkvc])\.", r"attnpool.\1_proj."))


# the stock OpenAI CLIP models the smoke writes, at their published shapes: (visual, text) config
# keywords; ClipVitConfig's and ClipResNetConfig's defaults are ViT-L/14's and RN50's visual towers
CLIP_SHAPES = {"ViT-L/14": ({}, {"width": 768, "heads": 12, "layers": 12, "embed_dim": 768}),
               "RN50": ({}, {"width": 512, "heads": 8, "layers": 12, "embed_dim": 1024})}


def clip_configs(kind: str):
    """-> (visual config, text config) of ``CLIP_SHAPES[kind]``."""
    from helping_hand_for_egocentric_videos_torch.models import clip_image as ci
    from helping_hand_for_egocentric_videos_torch.models.clip_text import TextConfig

    vkw, tkw = CLIP_SHAPES[kind]
    return (ci.ClipVitConfig if kind.startswith("ViT") else ci.ClipResNetConfig)(**vkw), TextConfig(**tkw)


def openai_clip_state_dict(kind: str, device, seed: int) -> dict:
    """Seeded random weights of a stock OpenAI CLIP at its published shapes
    (``CLIP_SHAPES``), in OpenAI's key layout, f32 on the CPU: "ViT-L/14"
    (visual width 1024, 24 layers, patch 14, 224 px, ``visual.proj`` (1024,
    768); text 768 x 12, vocabulary 49408, context 77) or "RN50" (layers
    (3, 4, 6, 3), width 64, output 1024, 224 px; text 512 x 12, embedding
    1024), BatchNorm statistics away from the identity. The inverse of the
    port's converters."""
    import math

    import torch

    from helping_hand_for_egocentric_videos_torch.models import clip_image as ci
    from helping_hand_for_egocentric_videos_torch.models.clip_text import TextTransformer

    gen = torch.Generator(device=device).manual_seed(seed)
    vcfg, tcfg = clip_configs(kind)
    if kind.startswith("ViT"):
        visual = ci.ClipVisionTransformer(vcfg, generator=gen, device=device)
        names = _CLIP_BLOCK_NAMES
    else:
        visual = ci.ClipResNet(vcfg, generator=gen, device=device)
        with torch.no_grad():
            for bn in (m for m in visual.modules() if isinstance(m, ci.BatchNorm)):
                bn.weight.normal_(1.0, 0.1, generator=gen)
                bn.bias.normal_(0.0, 0.1, generator=gen)
                bn.running_mean.normal_(0.0, 0.1, generator=gen)
                bn.running_var.uniform_(0.5, 1.5, generator=gen)
        names = _CLIP_RESNET_NAMES
    text = TextTransformer(tcfg, generator=gen, device=device)
    sd = _renamed(visual.state_dict(), names, "visual.")
    sd.update(_renamed(text.state_dict(), ((r"^token_embedding$", "token_embedding.weight"),
                                                *_CLIP_BLOCK_NAMES)))
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07))
    return sd


def phase_clip_bootstrap(card, fixture, root: Path, device="cuda"):
    """"clip-bootstrap": a synthetic stock OpenAI ViT-L/14 (its published
    shapes, ``openai_clip_state_dict``) written with ``torch.save`` trains
    through ``cli.train.main --backbone_ckpt`` for ``BOOT_STEPS`` steps of
    ``BOOT_ITEMS`` items (16 clips with their negatives, the "train"
    phase's shape): the TimeSformer bootstrapped from it (zero time
    attention), finite losses, K1 and K2 24 times a step, every K2 output
    of the first step exactly zero with finite CLS partials, the converted
    spatial and text weights equal to the written ones, and the frozen
    backbone unchanged after the steps. -> (launches, the checkpoint's
    path)."""
    from types import SimpleNamespace

    import torch

    from helping_hand_for_egocentric_videos_torch.models import lavila
    from helping_hand_for_egocentric_videos_torch.models import spacetime_vit as stv

    t0 = time.perf_counter()
    sd = openai_clip_state_dict("ViT-L/14", device, SEED + 31)
    vcfg, tcfg = clip_configs("ViT-L/14")
    path = root / "ViT-L-14.pt"
    torch.save(sd, path)
    write_s = time.perf_counter() - t0
    meta, data = fixture
    real, seen = stv.divided_patch_attention, []

    def probe(qkv, ck, cv, cq, *, mode, **kw):  # the first step's K2 calls: largest |output|, finite partials
        out = real(qkv, ck, cv, cq, mode=mode, **kw)
        if mode == "time" and len(seen) < vcfg.layers:
            seen.append((out[0].abs().amax().float(), torch.stack([torch.isfinite(x).all() for x in out[1]]).all()))
        return out

    stv.divided_patch_attention = probe
    try:
        # --batch_size after _loop_argv's own: the last one counts
        run = _run_loop(_loop_argv(meta, data, root / "runs", "clip", "--backbone_ckpt", str(path), "--max_steps",
                                   str(BOOT_STEPS), "--batch_size", str(BOOT_ITEMS), *_loop_sets()),
                        keep_backbone=True)
    finally:
        stv.divided_patch_attention = real
    per_forward = launches_per_forward(SimpleNamespace(lavila_cfg=lavila.timesformer_large_config(LOOP_T),
                                                       int8=False))
    counts = _expect_launches(run, per_forward, BOOT_STEPS, run["val"])
    k2_max = [float(m) for m, _ in seen]
    k2_finite = all(bool(f) for _, f in seen)
    backbone = run.pop("backbone")
    written = []
    for i in range(vcfg.layers):
        blk, src = backbone.visual.blocks[i], f"visual.transformer.resblocks.{i}"
        written += [torch.equal(blk.attn.qkv.weight.cpu(), sd[f"{src}.attn.in_proj_weight"]),
                    torch.equal(blk.mlp_fc2.weight.cpu(), sd[f"{src}.mlp.c_proj.weight"]),
                    not blk.timeattn.qkv.weight.any(), bool((blk.timeattn.proj.weight == 1).all())]
    for i in range(tcfg.layers):
        written.append(torch.equal(backbone.text.blocks[i].attn.wq.weight.cpu(),
                                   sd[f"transformer.resblocks.{i}.attn.in_proj_weight"][:tcfg.width]))
    conv = sd["visual.conv1.weight"].permute(0, 2, 3, 1).reshape(vcfg.width, -1)
    written.append(torch.equal(backbone.visual.patch_embed.weight.cpu(), conv))
    losses = _losses(run["train"])
    res = {"card": card, "checkpoint_gb": path.stat().st_size / 1e9, "write_seconds": write_s,
           "steps": run["state"].step, "clips_per_step": 2 * BOOT_ITEMS, "total_loss": losses,
           "launches": run["launches"], "launches_per_step": per_forward, **counts, "finite": run["finite"],
           "k2_first_step_max_abs": max(k2_max) if k2_max else None, "k2_calls_seen": len(k2_max),
           "k2_partials_finite": k2_finite, "converted_equal_written": all(written),
           "backbone_unchanged": run["backbone_unchanged"], "seconds": run["seconds"],
           "peak_memory_gb": run["peak_memory_gb"], "step_ms": _window_ms(run["train"])}
    say("clip-bootstrap", **res)
    if not (run["state"].step == BOOT_STEPS and run["finite"] and sorted(losses) == list(range(1, BOOT_STEPS + 1))
            and len(k2_max) == vcfg.layers and max(k2_max) == 0.0 and k2_finite and all(written)
            and run["backbone_unchanged"] and run["frozen_unchanged"]):
        raise AssertionError("clip-bootstrap: the bootstrapped backbone did not train as it must (clip-bootstrap line)")
    launches = run["launches"]
    del backbone, run
    torch.cuda.empty_cache()
    return launches, path


def phase_clip_zoo(card, vit_path: Path, root: Path, device="cuda"):
    """"clip-zoo": ``models.zoo.load_clip`` on the ViT-L/14 file of
    "clip-bootstrap" and on a synthetic RN50 at its published widths, each
    tower and config at its published shape; ``clip_preprocess`` of
    ``ZOO_B`` uint8 frames of 256 x 342 on the card (against the CPU's);
    the image and text towers on the card against the CPU in f32 (within
    1e-3 of the CPU's largest value, 2 images, 2 captions), and the
    card's images/s in f32 and bf16 at ``ZOO_B`` images (CUDA events)."""
    import copy

    import torch

    from helping_hand_for_egocentric_videos_torch.models import zoo
    from helping_hand_for_egocentric_videos_torch.models.clip_text import encode_text

    rn_path = root / "RN50.pt"
    torch.save(openai_clip_state_dict("RN50", device, SEED + 32), rn_path)
    frames = torch.from_numpy(np.random.default_rng(SEED + 33).integers(0, 256, size=(ZOO_B, 256, 342, 3),
                                                                        dtype=np.uint8))
    imgs = zoo.clip_preprocess(frames.to(device))
    imgs_cpu = zoo.clip_preprocess(frames)
    pre_err = float((imgs.cpu() - imgs_cpu).abs().max())
    tokens = torch.zeros(2, 77, dtype=torch.long)  # [SOT, words, EOT, padding]
    tokens[:, 0] = 49406
    tokens[0, 1:5] = torch.tensor([320, 1125, 518, 49407])
    tokens[1, 1:3] = torch.tensor([3305, 49407])
    out = {}
    ok = imgs.device.type == torch.device(device).type and imgs.shape == (ZOO_B, 224, 224, 3) and pre_err <= 1e-4
    for name, path in (("ViT-L/14", vit_path), ("RN50", rn_path)):
        t0 = time.perf_counter()
        z = zoo.load_clip(str(path))
        load_s = time.perf_counter() - t0
        vcfg, tcfg, enc = z["visual_cfg"], z["text_cfg"], z["encode_image"]
        shapes_ok = (vcfg, tcfg) == clip_configs(name)
        vis, txt = copy.deepcopy(z["visual_params"]).to(device), copy.deepcopy(z["text_params"]).to(device)
        with torch.inference_mode():
            want = enc(z["visual_params"], vcfg, imgs_cpu[:2])
            got = enc(vis, vcfg, imgs[:2]).cpu()
            want_t = encode_text(z["text_params"], tcfg, tokens)[0]
            got_t = encode_text(txt, tcfg, tokens.to(device))[0].cpu()
            ms = {dt: cuda_ms(lambda dt=dt: enc(vis, vcfg, imgs, dtype=getattr(torch, dt)), 5)
                  for dt in ("float32", "bfloat16")}
        rel = float((got - want).abs().max() / want.abs().max())
        rel_t = float((got_t - want_t).abs().max() / want_t.abs().max())
        out[name] = {"kind": z["kind"], "load_seconds": load_s, "published_shapes": shapes_ok,
                     "embed_dim": list(got.shape), "card_vs_cpu_rel_err": rel, "text_card_vs_cpu_rel_err": rel_t,
                     "images": ZOO_B, "ms": ms, "images_per_s": {dt: ZOO_B / (v / 1e3) for dt, v in ms.items()}}
        ok = ok and shapes_ok and z["kind"] == ("vit" if name == "ViT-L/14" else "resnet") and rel <= 1e-3 \
            and rel_t <= 1e-3 and bool(torch.isfinite(got).all())
        del z, vis, txt
        torch.cuda.empty_cache()
    say("clip-zoo", card=card, preprocess={"device": str(imgs.device), "shape": list(imgs.shape),
                                           "card_vs_cpu_max_abs": pre_err}, towers=out, rel_limit=1e-3)
    rn_path.unlink()
    if not ok:
        raise AssertionError("clip-zoo: a tower, its shapes or the preprocessing disagree (clip-zoo line)")


def phase_doctor(card):
    """"doctor": ``cli.doctor.main()`` on the card, after every kernel was
    built: usable, the card among the devices, each kernel library of
    ``csrc/`` in the build directory, rc 0."""
    import contextlib

    import torch

    from helping_hand_for_egocentric_videos_torch.cli import doctor
    from helping_hand_for_egocentric_videos_torch.ops import _build

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = doctor.main(["--timeout", "120"])
    rep = json.loads(buf.getvalue())
    want = sorted(_build._target(p.stem)[1].name for p in _build.SOURCES.glob("*.cu"))
    name = torch.cuda.get_device_name(0)
    res = {"card": card, "rc": rc, "seconds": time.perf_counter() - t0,
           **{k: rep[k] for k in ("usable", "devices", "device_smoke", "kernel_build", "native_stage",
                                  "decode_backends", "bpe_vocab")}, "libraries_expected": want}
    say("doctor", **res)
    if not (rc == 0 and rep["usable"] and any(name in d for d in rep["devices"] or [])
            and set(want) <= set(rep["kernel_build"]["libraries"]) and rep["kernel_build"]["nvcc"]):
        raise AssertionError("doctor: the report does not show a usable card with its kernels (doctor line)")


def phase_profile(card, log_dir: Path):
    """"profile": ``utils.profiling.top_ops`` on the trace of the train
    loop's profile step: device rows (kernels) with names, and the table
    printed; and the trace must hold every attention launch of that bf16
    step, K1 and K2 24 times each (``utils.profiling.trace`` opens and
    closes its window on idle margins, so no edge kernel is lost)."""
    from helping_hand_for_egocentric_videos_torch.utils.profiling import top_ops

    rows = top_ops(str(log_dir), k=20)
    device_rows = [r for r in rows if r[1] == "device"]
    events = json.loads((log_dir / "trace.json").read_text())["traceEvents"]
    attention = sum(e.get("ph") == "X" and e.get("cat") == "kernel" and ATTENTION_KERNEL in e.get("name", "")
                    for e in events)
    want = 2 * 24
    say("profile", card=card, trace=str(log_dir / "trace.json"), rows=len(rows), device_rows=len(device_rows),
        attention_launches=attention, attention_launches_expected=want,
        table=[{"self_ms": ms, "where": where, "name": name} for ms, where, name in rows])
    if not (device_rows and all(isinstance(r[2], str) and r[2] and r[0] >= 0 for r in rows)):
        raise AssertionError("profile: top_ops shows no device rows in the loop's trace (profile line)")
    if attention != want:
        raise AssertionError(f"profile: the traced step holds {attention} attention launches, not {want}: the "
                             "trace lost kernel events (profile line)")


def phase_eval(card, device="cuda", backbone="timesformer_large") -> dict:
    """The eval phases and "visualize" on one pair of reference-layout
    checkpoints (full width, 4 frames), written under ``build/``. -> their
    launches."""
    import gc

    import torch

    root = BUILD / "chip_smoke_eval"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        bpath, dpath, model, decoder, write_s = write_reference_checkpoints(root, device, SEED + 20, backbone)
        del model, decoder
        gc.collect()
        torch.cuda.empty_cache()
        say("eval-checkpoints", checkpoint_frames=CKPT_T, write_seconds=write_s)
        ckpts = (bpath, dpath)
        launches = [phase_eval_egomcq(card, ckpts, root, device, backbone)]
        epic_launches, epic, epic_results = phase_eval_epic(card, ckpts, root, device, backbone)
        launches.append(epic_launches)
        for phase in (phase_eval_egtea, partial(phase_eval_tools, epic=epic, epic_results=epic_results),
                      phase_visualize):
            gc.collect()
            torch.cuda.empty_cache()
            launches.append(phase(card, ckpts, root=root, device=device, backbone=backbone))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {k: sum(r[k] for r in launches) for k in counters()}


def main():
    if sys.argv[1:2] == ["--tp-worker"]:  # a rank of phase_train_tp, started by it
        rank, port, out, meta, data, device, backbone_name = sys.argv[2:9]
        return tp_worker(int(rank), int(port), out, meta, data, device, backbone_name)
    name, card = phase_device()
    import gc

    import torch

    from helping_hand_for_egocentric_videos_torch.train import EvalModel
    from helping_hand_for_egocentric_videos_torch.utils.flops import peaks_for

    peaks = peaks_for(name)
    ptxas = phase_build()
    if sys.argv[1:2] == ["--sampler"]:  # the sampler kernel (K7) alone
        phase_sampler("cuda", peaks, ptxas)
        return
    if sys.argv[1:2] == ["--decode-attention"]:  # the decode-attention kernel (K8) alone
        phase_decode_attention("cuda", peaks, ptxas)
        return
    if sys.argv[1:2] == ["--latent-softmax"]:  # the latent softmax kernel (K9) alone
        phase_latent_softmax("cuda", peaks, ptxas)
        return
    report = phase_kernels("cuda", peaks)
    local = _time_local_heads("cuda", peaks)  # the model axis's K1/K2 shapes
    for row in local:
        report[row["mode"]].setdefault("local_heads", []).append(row)
    report.update(phase_int8_kernels("cuda", peaks))
    report["sampler"] = phase_sampler("cuda", peaks, ptxas)
    report["decode_attention"] = phase_decode_attention("cuda", peaks, ptxas)
    report["latent_softmax"] = phase_latent_softmax("cuda", peaks, ptxas)
    for check in _check_cell_shapes("cuda"):  # the batches of the benchmark's cells
        key = check["kernel"].removeprefix("divided_attention_")
        report[key if key in report else check["kernel"]].setdefault("cell_shapes", []).append(check)
    for key, cells in _time_train_shapes("cuda", peaks).items():  # before the phases that spoil traces
        report[key].update({"train_shape": cells["train"], "loop_shape": cells["train-loop"]})
    phase_profiler_check("after phase 4")
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
    launches_eval = phase_eval(card)
    launches_train, _ = phase_train(card, peaks)
    loop_root = BUILD / "chip_smoke_loop"
    shutil.rmtree(loop_root, ignore_errors=True)
    launches_loop, fixture, _ = phase_train_loop(card, loop_root)
    launches_loop8, ref_losses = phase_train_loop_int8(card, fixture, loop_root)
    launches_dist = phase_train_loop_dist(card, fixture, loop_root, ref_losses)
    phase_profile(card, loop_root / "runs" / "loop" / "profile")
    gc.collect()
    torch.cuda.empty_cache()
    launches_tp = phase_train_tp(card, loop_root, checked={(r["mode"], r["H"], r["B"], r["T"]) for r in local})
    launches_boot, vit_path = phase_clip_bootstrap(card, fixture, loop_root)
    phase_clip_zoo(card, vit_path, loop_root)
    shutil.rmtree(loop_root, ignore_errors=True)
    phase_doctor(card)
    phase_profiler_check("end")
    # launches on the main path: the serving runs at 16 and at 128 frames, bf16
    # and int8, the eval CLIs and visualize, the train steps, the training loops,
    # both ranks of the split backbone's steps and loop, and the loop on the CLIP
    # bootstrap
    total = {k: launches[k] + launches8[k] + launches_long[k] + launches_eval[k] + launches_train[k]
             + launches_loop[k] + launches_loop8[k] + launches_dist[k] + launches_tp[k] + launches_boot[k]
             for k in counters()}
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
    own = ("sampler", "decode_attention", "latent_softmax")  # launched in their own phases: no narration here
    for key in own:
        report[key]["card"] = card
    print(json.dumps({"kernels": [report[k] for k in (*counts, *own)]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
