#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port on one NVIDIA GPU (written for an H100).

Counterpart of the repository's ``bench.py``, with its stages, metric
names, keys and order, on ``helping_hand_for_egocentric_videos_torch``
(never JAX, never the JAX package). One JSON line a stage:

1. ``device_probe``: the bounded subprocess probe of the card
   (``cli.common.bounded_device_probe``), before this process touches CUDA;
2. ``train_clips_per_sec_per_chip_4f``: the pretraining step
   (``train.make_train_step``: the frozen TimeSformer-L forward in bf16,
   the object decoder, EgoNCE, box and word losses, AdamW) on 16 clips of
   4 frames, 5 captions a clip, the batch of bench.py:112-135 from numpy
   seed 0; ``_int8_backbone``: the same with the visual tower quantized;
   ``_augmented`` (only under ``HH_BENCH_AUG=1``): uint8 clips of 256 x 256
   augmented on the card;
3. ``clips_per_sec_e2e_16f_eval_bf16``: a chunked ``.npy`` store of 256 x 342
   frames through ``data.read_clip_chunked``, ``ShardedSampler`` and
   ``PrefetchLoader`` (4 threads, depth 2), ``pinned_put`` onto the card,
   ``EvalModel.preprocess_video`` (``ops.resize_normalize``) there and the
   bf16 eval forward, 8 clips a batch; with the host stage alone, the
   measured host-to-device MB/s and the rate on clips already staged on
   the card;
4. ``clips_per_sec_per_chip_16f_eval_int8``: the 16-frame eval forward
   (``EvalModel.embed_clips``: the visual tower, the decoder, ``obj_proj``
   of the last query) with the visual tower in int8 (K3, K4, K5,
   ``torch._int_mm``), tagged ``gated_on: real_weight_validation``;
5. ``clips_per_sec_per_chip_16f_eval``, last: the same forward in bf16 (K1,
   K2), the headline.

Weights are random from a seed; time attention gets N(0, 0.02) weights (it
starts at zero in the model), so its kernel sees non-zero inputs. Each
stage makes one warm call outside the clock (it also builds the kernels)
and ends its timed window with ``torch.cuda.synchronize()``. Every value
line also carries the card and its power limit (``nvidia-smi``), the peak
of ``torch.cuda.max_memory_allocated``, ``mfu`` against the card's dense
peak (``utils.flops.PEAKS``), ``launches``: each kernel's launches a
forward or a step, read from the port's counters over the warm call, and
``launches_total``: its launches over the whole stage.

``vs_baseline`` divides by bench.py's assumed 30 clips/s: an analytic
estimate for the reference's fp16 eval on one NVIDIA A100, no measured
number and no TPU figure (``baseline_assumed: true``).

Exit codes: 0 when every stage ran; 1 when a stage raised (its
``<stage>_error`` line is printed and the remaining stages still run);
2 when the probe failed (``gpu_unavailable``, before any CUDA call);
3 when the watchdog found the run stalled (``gpu_stalled_midrun``). A
stage skipped for the time budget (``<stage>_skipped``) is no error. There
is no CPU fallback. Environment: ``HH_BENCH_INT8``, ``HH_BENCH_TRAIN``,
``HH_BENCH_E2E`` (0 skips the stage), ``HH_BENCH_AUG`` (1 adds it),
``HH_BENCH_TRAIN_BS`` (clips a train step), ``HH_BENCH_BUDGET`` (seconds),
``HH_BENCH_PROBE_TIMEOUT``, ``HH_BENCH_GRACE``, ``HH_BENCH_STALL``.

    python3 tools/torch_bench.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from helping_hand_for_egocentric_videos_torch.cli.common import bounded_device_probe  # noqa: E402
from helping_hand_for_egocentric_videos_torch.ops.counts import read_counts, reset_counts  # noqa: E402
from helping_hand_for_egocentric_videos_torch.utils.flops import (  # noqa: E402
    eval_fwd_flops_per_clip,
    peaks_for,
    text_fwd_flops,
    train_step_flops_per_clip,
    vision_fwd_flops,
)

REFERENCE_CLIPS_PER_SEC = 30.0
# bench.py's derivation, kept word for word: an analytic estimate for the
# reference's fp16 eval on one NVIDIA A100, not a measured number
BASELINE_SOURCE = (
    "analytic estimate, no published number: ~3.4 TFLOP/clip fwd "
    "(utils/flops.py counter; BENCH_NOTES.md roofline) / A100 fp16 peak "
    "312 TF/s @ assumed 32% util for eager bs=1 torch eval (BASELINE.md; "
    "the 32% figure is cross-checked by a measured same-host CPU "
    "utilisation of the actual reference in BASELINE_MEASURED.json)"
)
# Per-mode eval batch, set by the card's eval sweep (tools/torch_eval_sweep.py,
# PERF.md section 5): on an H100 80GB HBM3 at 700 W both types rise with the
# batch up to 64, the largest swept (bf16 76.2 -> 84.0 clips/s from 8 to 64,
# int8 31.7 -> 34.7; 13.4 and 18.0 GB at 64). bench.py's int8 batch of 16
# came from a TPU whose int8 kernels regressed past 16; here int8 does not.
EVAL_BATCH = {"bf16": 64, "int8": 64}
FRAMES = 16
STEPS = 5
TRAIN_T, TRAIN_R = 4, 5
NOUNS, VERBS = 582, 118
# the end-to-end store (bench.py:215): clips a batch, chunks, frames a chunk, frame size; batches
E2E_B, E2E_CHUNKS, E2E_CHUNK_FRAMES, E2E_HW, E2E_BATCHES = 8, 6, 96, (256, 342), 6
SEED = 0


def card_info(device) -> dict:
    """``{"card", "power_limit_w"}``: ``nvidia-smi``'s name and power
    limit of the CUDA card, or ``"cpu"`` and None."""
    if torch.device(device).type != "cuda":
        return {"card": "cpu", "power_limit_w": None}
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    return card_from_line(line)


def card_from_line(line: str | None) -> dict:
    """``"NVIDIA H100 80GB HBM3, 700.00 W"`` -> card and power limit in W."""
    if not line:
        return {"card": None, "power_limit_w": None}
    watts = line.rsplit(",", 1)[-1].strip().removesuffix("W").strip()
    try:
        return {"card": line, "power_limit_w": float(watts)}
    except ValueError:
        return {"card": line, "power_limit_w": None}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak_gb(device):
    if torch.device(device).type != "cuda":
        return None
    return round(torch.cuda.max_memory_allocated(device) / 1e9, 3)


def _peak_tflops(device, kind: str) -> float | None:
    """The card's dense peak of ``kind`` in TFLOP/s (TOP/s for int8); None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    return peaks_for(torch.cuda.get_device_name(device))[kind] / 1e12


def _mfu(rate: float, flops: float, peak_tf: float | None):
    return None if peak_tf is None else round(rate * flops / (peak_tf * 1e12), 4)


def _counts() -> dict:
    """Each kernel's launches since the counts were last set to 0
    (``ops.counts.reset_counts``), kernels not launched left out."""
    return {k: v for k, v in read_counts().items() if v}


def _launches(fn):
    """Run ``fn`` once with every kernel's launch count set to 0 just
    before -> (its result, the launches it made). The counts keep running
    after it, so a stage's ``_counts()`` at its end covers the stage."""
    reset_counts()
    out = fn()
    return out, _counts()


def configs(backbone: str, frames: int, pred_traj: bool):
    """(lavila_cfg, dec_cfg) of ``backbone`` at ``frames`` frames, the
    decoder at its default widths over that backbone's features."""
    from helping_hand_for_egocentric_videos_torch.models import DecoderConfig, lavila

    lcfg = getattr(lavila, f"{backbone}_config")(num_frames=frames)
    dcfg = DecoderConfig(num_frames=frames, feature_dim=lcfg.visual.width, text_width=lcfg.text.width,
                         patches_per_frame=lcfg.visual.patches_per_frame, pred_traj=pred_traj)
    return lcfg, dcfg


def build_models(lcfg, dcfg, device):
    """Seeded random ``Lavila`` and ``ObjDecoder`` on ``device``, time
    attention N(0, 0.02) (zero in the model, which would feed its kernel
    zeros)."""
    from helping_hand_for_egocentric_videos_torch.models import Lavila, ObjDecoder

    gen = torch.Generator(device=device).manual_seed(SEED)
    backbone = Lavila(lcfg, generator=gen, device=device)
    decoder = ObjDecoder(dcfg, generator=gen, device=device)
    with torch.no_grad():
        for blk in backbone.visual.blocks:
            blk.timeattn.qkv.weight.normal_(0.0, 0.02, generator=gen)
            blk.timeattn.proj.weight.normal_(0.0, 0.02, generator=gen)
    return backbone, decoder


# ---------------------------------------------------------------- train


def train_batch(n_videos: int, t: int = TRAIN_T, r: int = TRAIN_R, *, augment: bool = False, res: int = 224,
                text_width: int = 768):
    """bench.py:112-135's batch from numpy seed ``SEED`` -> (batch of numpy
    arrays, noun dictionary (582, ``text_width``)). ``augment``: raw
    uint8 clips of 256 x 256 in place of normalised f32 ones of ``res``."""
    rng = np.random.default_rng(SEED)
    tokens = np.zeros((n_videos * r, 77), np.int64)
    tokens[:, 0] = 49406
    tokens[:, 1:5] = rng.integers(1, 49000, size=(n_videos * r, 4))
    tokens[:, 5] = 49407
    if augment:  # the augmentation takes raw uint8 at the decode size
        video = rng.integers(0, 256, size=(n_videos, t, 256, 256, 3)).astype(np.uint8)
    else:
        video = rng.normal(size=(n_videos, t, res, res, 3)).astype(np.float32)
    batch = {
        "video": video,
        "tokens": tokens,
        "noun_vec": (rng.random((n_videos, NOUNS)) < 0.02).astype(np.float32),
        "verb_vec": (rng.random((n_videos, VERBS)) < 0.05).astype(np.float32),
        "boxes": (rng.random((n_videos, t, 4, 4)) * 150).astype(np.float32) + np.array([0, 0, 60, 60], np.float32),
        "nouns": rng.integers(0, NOUNS, size=(n_videos, 4)).astype(np.int64),
    }
    noun_dict = rng.normal(size=(NOUNS, text_width)).astype(np.float32)
    return batch, noun_dict


def train_setup(n_videos: int, *, int8_backbone: bool = False, augment: bool = False, device="cuda",
                backbone: str = "timesformer_large", models=None, tcfg=None):
    """The bench's train step and its inputs -> (lavila_cfg, backbone,
    dec_cfg, state, step, batch, noun_dict), the batch and dictionary as
    tensors on ``device``. ``models``: (lavila_cfg, backbone, dec_cfg,
    decoder) to use in place of seeded ``backbone`` ones; ``tcfg``: the
    ``TrainConfig`` (default: bench.py's)."""
    from helping_hand_for_egocentric_videos_torch.models import quantize_lavila_params
    from helping_hand_for_egocentric_videos_torch.train import TrainConfig, TrainState, make_train_step

    if models is None:
        lcfg, dcfg = configs(backbone, TRAIN_T, pred_traj=True)
        tower, decoder = build_models(lcfg, dcfg, device)
    else:
        lcfg, tower, dcfg, decoder = models
        tower = tower.to(device)
    if int8_backbone:
        tower = quantize_lavila_params(tower)
    tower.requires_grad_(False)
    if tcfg is None:
        tcfg = TrainConfig(augment=augment, color_jitter=(0.2, 0.2, 0.1) if augment else (0.0, 0.0, 0.0))
    state = TrainState.create(decoder, tcfg, device=device)
    step = make_train_step(dcfg, lcfg, tcfg)
    batch, noun_dict = train_batch(n_videos, lcfg.visual.num_frames, tcfg.rephrase_factor, augment=augment,
                                   res=lcfg.visual.img_size, text_width=lcfg.text.width)
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    return lcfg, tower, dcfg, state, step, batch, torch.as_tensor(noun_dict, device=device)


def bench_train_step(int8_backbone: bool = False, augment: bool = False, *, batch: int | None = None,
                     steps: int = STEPS, device="cuda", backbone: str = "timesformer_large", card=None) -> dict:
    """bench.py's ``bench_train_step``: ``steps`` timed steps after a warm
    one, dropout on (a seeded generator), on ``batch`` clips (default
    ``$HH_BENCH_TRAIN_BS``, else 16). -> the line."""
    n_videos = batch or int(os.environ.get("HH_BENCH_TRAIN_BS", "16"))
    card = card or card_info(device)
    _reset_peak(device)
    lcfg, tower, dcfg, state, step, data, noun_dict = train_setup(
        n_videos, int8_backbone=int8_backbone, augment=augment, device=device, backbone=backbone)
    gen = torch.Generator(device=device).manual_seed(1)
    (state, metrics), launches = _launches(lambda: step(state, tower, data, noun_dict, gen))
    if not np.isfinite(float(metrics["total_loss"])):  # warm-up and sync
        raise FloatingPointError(f"the warm train step's loss is {float(metrics['total_loss'])}")
    gen.manual_seed(2)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, tower, data, noun_dict, gen)
    _sync(device)
    dt = time.perf_counter() - t0
    float(metrics["total_loss"])
    clips_per_sec = n_videos * steps / dt

    # the frozen backbone runs forward only (no_grad), the decoder forward and backward
    r = TRAIN_R
    train_flops = train_step_flops_per_clip(lcfg, dcfg, rephrase_factor=r)
    bf16 = _peak_tflops(device, "bfloat16")
    if int8_backbone and bf16 is not None:
        # bench.py's mixed peak: the frozen towers on the int8 peak, the rest on bf16's
        frozen = vision_fwd_flops(lcfg.visual) + r * text_fwd_flops(lcfg.text)
        peak_tf = train_flops / (frozen / _peak_tflops(device, "int8") + (train_flops - frozen) / bf16)
    else:
        peak_tf = bf16
    line = {
        "metric": "train_clips_per_sec_per_chip_4f"
        + ("_int8_backbone" if int8_backbone else "")
        + ("_augmented" if augment else ""),
        "value": round(clips_per_sec, 3),
        "unit": "clips/s",
        "vs_baseline": None,  # the reference publishes no train throughput
        "train_tflop_per_clip": round(train_flops / 1e12, 4),
        "mfu": _mfu(clips_per_sec, train_flops, peak_tf),
        "mfu_peak_assumed_tflops": None if peak_tf is None else round(peak_tf, 1),
        "batch_videos": n_videos,
        "step_ms": round(1e3 * dt / steps, 3),
        **card,
        "peak_memory_gb": _peak_gb(device),
        "launches": launches,
        "launches_total": _counts(),
    }
    if int8_backbone:
        line["gated_on"] = "real_weight_validation"
    return line


# ----------------------------------------------------------------- eval


def make_eval_model(backbone, lcfg, decoder, dcfg, *, quantize: bool = False, dtype=torch.bfloat16):
    """bench.py's eval model: the port's ``EvalModel`` over ``backbone`` and
    ``decoder`` on their device, the visual tower in ``dtype``
    (``quantize``: its block matmuls in int8 first). Its ``embed_clips``
    is the timed forward: the tower, the decoder on the patch grid in f32,
    ``obj_proj`` of the last query."""
    from helping_hand_for_egocentric_videos_torch.train import EvalModel

    return EvalModel(backbone, lcfg, decoder, dcfg, None, input_res=lcfg.visual.img_size, dtype=dtype,
                     device=next(backbone.parameters()).device, int8=quantize)


def eval_video(batch: int, frames: int = FRAMES, res: int = 224) -> np.ndarray:
    """bench.py's eval input: N(0, 1) f32 clips from numpy seed ``SEED``."""
    return np.random.default_rng(SEED).normal(size=(batch, frames, res, res, 3)).astype(np.float32)


def bench_eval(quantize: bool, *, batch: int | None = None, steps: int = STEPS, device="cuda",
               backbone: str = "timesformer_large", card=None) -> dict:
    """bench.py's ``main(quantize)``: the 16-frame eval forward at
    ``EVAL_BATCH`` (or ``batch``) clips, ``steps`` timed calls after a warm
    one. -> the line."""
    batch = batch or EVAL_BATCH["int8" if quantize else "bf16"]
    card = card or card_info(device)
    _reset_peak(device)
    lcfg, dcfg = configs(backbone, FRAMES, pred_traj=False)
    tower, decoder = build_models(lcfg, dcfg, device)
    forward = make_eval_model(tower, lcfg, decoder, dcfg, quantize=quantize).embed_clips
    del tower
    video = torch.as_tensor(eval_video(batch, FRAMES, lcfg.visual.img_size), device=device)
    (emb, _), launches = _launches(lambda: forward(video))
    emb.cpu()  # warm-up and sync
    t0 = time.perf_counter()
    for _ in range(steps):
        out = forward(video)
    _sync(device)
    dt = time.perf_counter() - t0
    out[0].cpu()
    clips_per_sec = batch * steps / dt
    flops = eval_fwd_flops_per_clip(lcfg, dcfg)
    peak_tf = _peak_tflops(device, "int8" if quantize else "bfloat16")
    line = {
        "metric": "clips_per_sec_per_chip_16f_eval" + ("_int8" if quantize else ""),
        "value": round(clips_per_sec, 3),
        "unit": "clips/s",
        "batch": batch,
        "vs_baseline": round(clips_per_sec / REFERENCE_CLIPS_PER_SEC, 3),
        # the denominator is bench.py's estimate for one A100 (30 clips/s fp16),
        # not a measured number and not a TPU figure
        "baseline_assumed": True,
        "baseline_source": BASELINE_SOURCE,
        "mfu": _mfu(clips_per_sec, flops, peak_tf),
        "mfu_peak_assumed_tflops": peak_tf,
        "tflop_per_clip": round(flops / 1e12, 4),
        "forward_ms": round(1e3 * dt / steps, 3),
        **card,
        "peak_memory_gb": _peak_gb(device),
        "launches": launches,
        "launches_total": _counts(),
    }
    if quantize:
        line["quant"] = "int8-w8a8-dynamic"
        line["gated_on"] = "real_weight_validation"
    return line


# ----------------------------------------------------------- end to end


def write_clip_store(root: str) -> tuple[list[str], np.ndarray]:
    """bench.py's chunked store: ``E2E_CHUNKS`` copies of one chunk of
    ``E2E_CHUNK_FRAMES`` uint8 frames of ``E2E_HW`` (numpy seed ``SEED``),
    as ``<root>/<c>.mp4.npy``. -> (the clip paths ``<root>/<c>.mp4``, the
    chunk)."""
    frames = np.random.default_rng(SEED).integers(0, 256, size=(E2E_CHUNK_FRAMES, *E2E_HW, 3)).astype(np.uint8)
    paths = []
    for c in range(E2E_CHUNKS):
        np.save(os.path.join(root, f"{c}.mp4.npy"), frames)
        paths.append(os.path.join(root, f"{c}.mp4"))
    return paths, frames


class NpyClips:
    """bench.py's dataset over the store: item ``i`` is the 16-frame clip of
    chunk ``i % E2E_CHUNKS`` from second ``(0.37 i) mod 2`` to one second
    later (``read_clip_chunked``)."""

    def __init__(self, paths, n: int):
        self.paths, self.n = paths, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        from helping_hand_for_egocentric_videos_torch.data.video import read_clip_chunked

        start = (i * 0.37) % 2.0
        clip, _ = read_clip_chunked(self.paths[i % len(self.paths)], start, start + 1.0, clip_length=FRAMES)
        return {"video": clip}


def e2e_loader(dataset):
    """The host stage: ``E2E_B`` clips a batch in order, whole batches, 4
    decode threads, 2 batches ahead."""
    from helping_hand_for_egocentric_videos_torch.data.loader import PrefetchLoader, ShardedSampler

    return PrefetchLoader(dataset, ShardedSampler(len(dataset), E2E_B, shuffle=False, drop_last=True),
                          num_threads=4, depth=2)


def bench_e2e(*, device="cuda", backbone: str = "timesformer_large", card=None) -> dict:
    """bench.py's ``bench_e2e``: store -> host stage -> ``pinned_put`` ->
    ``resize_normalize`` on the device -> the bf16 eval forward. -> the
    line."""
    from helping_hand_for_egocentric_videos_torch.data.loader import device_prefetch, pinned_put

    card = card or card_info(device)
    _reset_peak(device)
    b = E2E_B
    lcfg, dcfg = configs(backbone, FRAMES, pred_traj=False)
    tower, decoder = build_models(lcfg, dcfg, device)
    model = make_eval_model(tower, lcfg, decoder, dcfg)
    del tower

    def forward_u8(video_u8):
        return model.embed_clips(model.preprocess_video(video_u8))

    with tempfile.TemporaryDirectory() as tmp:
        paths, frames = write_clip_store(tmp)
        dataset = NpyClips(paths, b * E2E_BATCHES)

        # -- host stage alone
        t0 = time.perf_counter()
        n_clips = sum(batch["video"].shape[0] for batch in e2e_loader(dataset))
        host_rate = n_clips / (time.perf_counter() - t0)

        # -- host-to-device copies of a uint8 batch, each waited for
        probe = np.ascontiguousarray(frames[:FRAMES][None].repeat(b, 0))
        pinned_put({"video": probe}, device)[0]["video"].max().item()  # warm the copy path
        t0 = time.perf_counter()
        for _ in range(3):
            pinned_put({"video": probe}, device)[0]["video"].max().item()
        infeed_mbps = probe.nbytes * 3 / (time.perf_counter() - t0) / 1e6

        # -- the forward on a batch already on the device
        staged = pinned_put({"video": probe}, device)[0]["video"]
        (emb, _), launches = _launches(lambda: forward_u8(staged))
        emb.cpu()
        t0 = time.perf_counter()
        for _ in range(3):
            out = forward_u8(staged)
        _sync(device)
        staged_rate = b * 3 / (time.perf_counter() - t0)
        out[0].cpu()

        # -- end to end: every batch timed, the loader made inside the window
        # so that its ramp-up counts (bench.py:282-291)
        total = 0
        t0 = time.perf_counter()
        for batch in device_prefetch(e2e_loader(dataset), lambda x: pinned_put(x, device)):
            out = forward_u8(batch["video"])
            total += batch["video"].shape[0]
        _sync(device)
        e2e_rate = total / (time.perf_counter() - t0)
        out[0].cpu()

    return {
        "metric": "clips_per_sec_e2e_16f_eval_bf16",
        "value": round(e2e_rate, 3),
        "unit": "clips/s",
        "host_stage_clips_per_sec": round(host_rate, 1),
        "device_infeed_MBps": round(infeed_mbps, 1),
        "staged_model_clips_per_sec": round(staged_rate, 3),
        "note": ("page-locked copies overlap the forward a batch ahead (data.device_prefetch), so "
                 "e2e ~= min(host_stage, staged_model)"),
        "batch": b,
        "mfu": _mfu(e2e_rate, eval_fwd_flops_per_clip(lcfg, dcfg), _peak_tflops(device, "bfloat16")),
        **card,
        "peak_memory_gb": _peak_gb(device),
        "launches": launches,
        "launches_total": _counts(),
    }


# ------------------------------------------------------ wedge-proofing


def watchdog_should_fire(now: float, t0: float, last_progress: float, deadline: float, stall: float) -> bool:
    """bench.py's predicate: fire only when the hard deadline has passed
    AND no stage completed within the last ``stall`` seconds."""
    return now - t0 >= deadline and now - last_progress >= stall


class Watchdog:
    """A daemon thread that ends the process with a ``gpu_stalled_midrun``
    line and exit code 3 once ``watchdog_should_fire`` holds; a healthy run
    may be silent for a long cold build, a wedged card for hours. Call
    ``progress()`` when a stage completes."""

    def __init__(self, deadline: float, stall: float):
        self.deadline, self.stall = deadline, stall
        self.t0 = self.last = time.monotonic()
        threading.Thread(target=self._watch, daemon=True).start()

    def progress(self):
        self.last = time.monotonic()

    def _watch(self):
        while True:
            time.sleep(30)
            if watchdog_should_fire(time.monotonic(), self.t0, self.last, self.deadline, self.stall):
                break
        _emit({"metric": "gpu_stalled_midrun", "value": 0.0, "unit": "clips/s", "vs_baseline": None,
               "detail": (f"hard deadline {self.deadline:.0f}s passed and no stage completed for "
                          f"{self.stall:.0f}s; the card likely wedged (see cli/doctor.py)")})
        os._exit(3)


def _emit(line: dict):
    print(json.dumps(line), flush=True)


def main() -> int:
    t_start = time.perf_counter()
    budget = float(os.environ.get("HH_BENCH_BUDGET", "900"))
    probe = bounded_device_probe(float(os.environ.get("HH_BENCH_PROBE_TIMEOUT", "120")))
    if probe is None:
        _emit({"metric": "gpu_unavailable", "value": 0.0, "unit": "clips/s", "vs_baseline": None,
               "detail": ("bounded device probe failed or timed out before any CUDA call in this process; "
                          "no usable CUDA device (run cli/doctor.py for a diagnosis)")})
        return 2
    watchdog = Watchdog(budget + float(os.environ.get("HH_BENCH_GRACE", "480")),
                        stall=float(os.environ.get("HH_BENCH_STALL", "1500")))
    card = card_from_line(probe.get("card"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed = []

    def run(stage, fn, reserve: float | None):
        """One stage: its line, or ``<stage>_skipped`` when less than
        ``reserve`` seconds of the budget remain (None: never skipped), or
        ``<stage>_error`` when it raises."""
        if reserve is not None and time.perf_counter() - t_start > budget - reserve:
            _emit({"metric": f"{stage}_skipped", "reason": "time budget"})
            return
        try:
            _emit(fn())
        except Exception as e:  # noqa: BLE001 -- the other stages and the headline still run
            traceback.print_exc()
            failed.append(stage)
            _emit({"metric": f"{stage}_error", "value": 0.0, "unit": "clips/s", "vs_baseline": None,
                   "error": f"{type(e).__name__}: {e}"[:300]})
        finally:
            watchdog.progress()
            torch.cuda.empty_cache()

    int8 = os.environ.get("HH_BENCH_INT8", "1") == "1"
    _emit({"metric": "device_probe", **probe})
    if os.environ.get("HH_BENCH_TRAIN", "1") == "1":
        run("train", lambda: bench_train_step(card=card), 120.0)
        if int8:
            run("train_int8", lambda: bench_train_step(int8_backbone=True, card=card), 90.0)
        if os.environ.get("HH_BENCH_AUG", "0") == "1":
            run("train_aug", lambda: bench_train_step(augment=True, card=card), 90.0)
    if os.environ.get("HH_BENCH_E2E", "1") == "1":
        run("e2e", lambda: bench_e2e(card=card), 90.0)
    # int8 first (gated), the unconditional bf16 line last: the headline
    if int8:
        run("eval_int8", lambda: bench_eval(True, card=card), 60.0)
    run("eval_bf16", lambda: bench_eval(False, card=card), None)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
