"""Video clip readers with gated decode backends.

Produces raw uint8 (T, H, W, C) frames on the host; all resize/normalise
work happens fused on-device (ops/preprocess.py). Backends, best first:

1. ``native``  — the C++ stage (native/hh_dataio.cpp): ffmpeg-pipe clip
   decode for mp4 chunks, threaded libjpeg for frame dirs.
2. ``pyav`` / ``cv2`` — used when those wheels exist in the environment.
3. ``pil``     — JPEG frame directories via PIL (always available here).
4. ``npy``     — pre-extracted ``.npy``/``.npz`` uint8 clip files (T,H,W,C):
   the fast path for training, where a one-time offline pass converts
   chunked mp4s into frame tensors.

Reader semantics match the reference:
- ``read_clip_chunked``: the EgoClip 600 s-chunk reader
  (read_frames_cv2_egoclip_decord, base/base_dataset.py:274-323): frame
  ids from ``get_frame_ids`` over a 30 fps chunk-relative window of
  max((end-start)*fps, clip_length) frames, cross-chunk continuation into
  the next chunk file. (The reference re-opens the SAME chunk for the
  continuation — a bug we do not reproduce; we open the true next chunk
  and fall back to tail resampling when it doesn't exist, matching its
  error path.)
- ``read_jpeg_frames``: Epic-Kitchens frame dirs
  (read_frames_cv2_epic, base:385-406), name format
  ``frame_%010d.jpg``.

Failures raise; lax/strict handling (black-frame fallback,
base/base_dataset.py:124-140) lives in the datasets.

A copy of ``helping_hand_for_egocentric_videos_tpu/data/video.py`` (the port imports
nothing of the JAX package); it runs on the host without JAX, so the same inputs and seed give
the same result in both packages.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Sequence

import numpy as np

from .samplers import get_frame_ids, sample_frames, sample_frames_start_end
from . import native

__all__ = [
    "available_backends",
    "read_clip_chunked",
    "read_clip_seconds",
    "read_jpeg_frames",
    "read_jpeg_paths",
    "read_frames_at",
    "resize_frames",
    "DECODE_RES",
]

# (H, W) the native ffmpeg backend decodes to; the chunked Ego4D release is
# 256-short-side. Other backends return the file's native resolution.
DECODE_RES = (256, 456)


def _try_import(name):
    try:
        return __import__(name)
    except ImportError:
        return None


_cv2 = _try_import("cv2")
_av = _try_import("av")


def available_backends():
    out = ["pil", "npy"]
    try:
        native.get_lib()
        out.insert(0, "native-jpeg")
        if native.has_ffmpeg():
            out.insert(0, "native-ffmpeg")
    except native.NativeUnavailable:
        pass
    if _cv2 is not None:
        out.append("cv2")
    if _av is not None:
        out.append("pyav")
    return out


# ------------------------------------------------------------------ mp4
def _decode_at_cv2(path: str, frame_ids: Sequence[int]) -> np.ndarray | None:
    cap = _cv2.VideoCapture(path)
    if not cap.isOpened():
        return None
    frames = []
    for idx in frame_ids:
        cap.set(_cv2.CAP_PROP_POS_FRAMES, max(idx, 0))
        ret, frame = cap.read()
        if not ret:
            frames.append(frames[-1] if frames else None)
            continue
        frames.append(_cv2.cvtColor(frame, _cv2.COLOR_BGR2RGB))
    cap.release()
    if any(f is None for f in frames):
        return None
    return np.stack(frames)


def _decode_at_pyav(path: str, frame_ids: Sequence[int]) -> np.ndarray | None:
    container = _av.open(path)
    stream = container.streams.video[0]
    want = sorted(set(int(i) for i in frame_ids))
    got = {}
    for i, frame in enumerate(container.decode(stream)):
        if i > want[-1]:
            break
        if i in want:
            got[i] = frame.to_rgb().to_ndarray()
    container.close()
    if not got:
        return None
    last = got[max(got)]
    return np.stack([got.get(int(i), last) for i in frame_ids])


def _video_num_frames(path: str) -> int | None:
    if _cv2 is not None:
        cap = _cv2.VideoCapture(path)
        if cap.isOpened():
            n = int(cap.get(_cv2.CAP_PROP_FRAME_COUNT))
            cap.release()
            return n
    if _av is not None:
        c = _av.open(path)
        n = c.streams.video[0].frames
        c.close()
        return int(n) if n else None
    return None


def read_frames_at(path: str, frame_ids: Sequence[int], fps: float = 30.0) -> np.ndarray:
    """Read specific frame indices from one video file. uint8 (T, H, W, C)."""
    npy = _maybe_npy(path)
    if npy is not None:
        ids = np.clip(np.asarray(frame_ids), 0, len(npy) - 1)
        return npy[ids]
    if _cv2 is not None:
        out = _decode_at_cv2(path, frame_ids)
        if out is not None:
            return out
    if _av is not None:
        out = _decode_at_pyav(path, frame_ids)
        if out is not None:
            return out
    try:
        if native.has_ffmpeg():
            # decode the [min, max] frame span at the nominal fps and pick;
            # output scaled to the configured decode resolution
            start = min(frame_ids) / fps
            span_len = max(frame_ids) - min(frame_ids) + 1
            dur = span_len / fps + 0.5
            h, w = DECODE_RES
            span = native.decode_clip_ffmpeg(path, start, dur, fps, w, h, span_len + 8)
            if len(span):
                rel = np.clip(np.asarray(frame_ids) - min(frame_ids), 0, len(span) - 1)
                return span[rel]
    except native.NativeUnavailable:
        pass
    raise RuntimeError(
        f"no mp4 decode backend available for {path}; backends: {available_backends()}"
    )


def resize_frames(frames: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Squash-resize a uint8 (T, H, W, C) clip to (T, h, w, C) on the host.

    Aspect ratio is deliberately ignored — the reference's eval transform is
    ``Resize((224, 224))`` straight from the native decode size
    (data_loader/transforms.py:38-75). Decoders return native sizes (e.g.
    256x456 chunked Ego4D), so every clip is normalised to one static shape
    here before batching; the device preprocess then squashes to input_res.
    """
    h, w = hw
    if frames.shape[1] == h and frames.shape[2] == w:
        return frames
    from PIL import Image

    return np.stack(
        [np.asarray(Image.fromarray(f).resize((w, h), Image.BILINEAR)) for f in frames]
    )


# mmap-handle LRU for the npy fast path: each clip read used to pay two
# np.load header parses (read_clip_chunked probes vlen, read_frames_at
# re-opens) — ~1 ms/clip of the measured host-stage budget (BENCH_NOTES
# r5 breakdown). Entries are validated by (mtime_ns, size); handles are
# read-only mmaps, safe to share across loader threads.
_NPY_CACHE_MAX = 64
_NPY_CACHE: "OrderedDict[str, tuple[tuple[int, int], np.ndarray]]" = OrderedDict()
_NPY_CACHE_LOCK = threading.Lock()


def _load_npy_cached(cand: str):
    try:
        st = os.stat(cand)
    except OSError:
        return None
    key_stat = (st.st_mtime_ns, st.st_size)
    with _NPY_CACHE_LOCK:
        ent = _NPY_CACHE.get(cand)
        if ent is not None and ent[0] == key_stat:
            _NPY_CACHE.move_to_end(cand)
            return ent[1]
    m = np.load(cand, mmap_mode="r")
    with _NPY_CACHE_LOCK:
        _NPY_CACHE[cand] = (key_stat, m)
        _NPY_CACHE.move_to_end(cand)
        while len(_NPY_CACHE) > _NPY_CACHE_MAX:
            _NPY_CACHE.popitem(last=False)
    return m


def _maybe_npy(path: str):
    """Pre-extracted clip tensors: <path>.npy next to / instead of the mp4."""
    for cand in (path, path + ".npy", os.path.splitext(path)[0] + ".npy"):
        if cand.endswith(".npy") and os.path.exists(cand):
            return _load_npy_cached(cand)
    return None


def read_clip_chunked(
    path: str,
    start_second: float,
    end_second: float,
    *,
    next_path: str | None = None,
    chunk_len: int = 600,
    fps: float = 30.0,
    clip_length: int = 4,
    jitter: bool = False,
    rng=None,
) -> tuple[np.ndarray, list[float]]:
    """EgoClip chunked-mp4 clip reader. Returns (frames u8 (T,H,W,C), secs)."""
    chunk_start = int(start_second) // chunk_len * chunk_len
    second_offset = start_second - chunk_start
    frame_offset = int(np.round(second_offset * fps))
    total_duration = max(int((end_second - start_second) * fps), clip_length)
    frame_ids = get_frame_ids(
        frame_offset, frame_offset + total_duration, num_segments=clip_length, jitter=jitter, rng=rng
    )

    npy = _maybe_npy(path)
    vlen = len(npy) if npy is not None else (_video_num_frames(path) or chunk_len * int(fps))

    if max(frame_ids) < vlen:
        frames = read_frames_at(path, frame_ids, fps)
    else:
        part1 = [i for i in frame_ids if i < vlen]
        part2 = [i for i in frame_ids if i >= vlen]
        try:
            if next_path is None or not _exists_any(next_path):
                raise FileNotFoundError(next_path)
            f1 = read_frames_at(path, part1, fps) if part1 else None
            f2 = read_frames_at(next_path, [i - vlen for i in part2], fps)
            frames = np.concatenate([x for x in (f1, f2) if x is not None], axis=0)
        except (FileNotFoundError, RuntimeError, OSError):
            # last chunk: resample the tail (reference error path,
            # base/base_dataset.py:316-321)
            frame_ids = get_frame_ids(
                min(frame_offset, vlen - 1), vlen, num_segments=clip_length, jitter=jitter, rng=rng
            )
            frames = read_frames_at(path, frame_ids, fps)
    return frames, [f / fps for f in frame_ids]


def _exists_any(path: str) -> bool:
    return any(
        os.path.exists(c)
        for c in (path, path + ".npy", os.path.splitext(path)[0] + ".npy")
    )


def read_clip_seconds(
    path: str,
    num_frames: int,
    *,
    sample: str = "uniform",
    start_sec: float | None = None,
    end_sec: float | None = None,
    fps: float = 30.0,
    rng=None,
) -> tuple[np.ndarray, list[int]]:
    """Charades-style whole-file / seconds-window reader
    (read_frames_cv2_charades, base/base_dataset.py:408-438): samples
    ``num_frames`` across the full video, or across the [start_sec,
    end_sec] frame window when given. Returns (frames u8, frame ids)."""
    npy = _maybe_npy(path)
    vlen = len(npy) if npy is not None else _video_num_frames(path)
    if not vlen:
        raise RuntimeError(f"cannot determine frame count of {path}")
    if start_sec is None and end_sec is None:
        ids = sample_frames(num_frames, vlen, sample=sample, rng=rng)
    else:
        start_f = max(0, int((start_sec or 0.0) * fps))
        end_f = min(int((end_sec if end_sec is not None else vlen / fps) * fps), vlen)
        # annotations can outlive a truncated video or be degenerate:
        # clamp to a non-empty increasing window
        end_f = max(end_f, 1)
        start_f = min(start_f, end_f - 1)
        ids = sample_frames_start_end(num_frames, start_f, end_f, sample=sample, rng=rng)
    return read_frames_at(path, ids, fps), list(ids)


def read_jpeg_paths(
    paths: Sequence[str],
    num_frames: int | None = None,
    *,
    sample: str = "uniform",
    rng=None,
) -> tuple[np.ndarray, list[int]]:
    """Something-Something-style explicit frame-path-list reader
    (read_frames_sth, base/base_dataset.py:455-470): samples
    ``num_frames`` of the given JPEG paths (all of them when None).
    Returns (frames u8 (T, H, W, C), sampled indices)."""
    if num_frames is None:
        ids = list(range(len(paths)))
    else:
        ids = list(sample_frames(num_frames, len(paths), sample=sample, rng=rng))
    chosen = [paths[i] for i in ids]
    try:
        h, w = native.jpeg_dims(chosen[0])
        return native.decode_jpeg_batch(chosen, h, w), ids
    except native.NativeUnavailable:
        from PIL import Image

        # match the native backend: every frame squashed to frame 0's dims
        # so mixed-size lists stack the same way on both backends
        first = Image.open(chosen[0]).convert("RGB")
        w, h = first.size
        frames = [np.asarray(first)]
        for p in chosen[1:]:
            im = Image.open(p).convert("RGB")
            if im.size != (w, h):
                im = im.resize((w, h), Image.BILINEAR)
            frames.append(np.asarray(im))
        return np.stack(frames), ids


def read_jpeg_frames(
    frame_dir: str,
    frame_ids: Sequence[int],
    name_fmt: str = "frame_{:010d}.jpg",
    out_hw: tuple[int, int] | None = None,
) -> np.ndarray:
    """Epic-Kitchens style frame-directory reader (threaded native JPEG)."""
    paths = [os.path.join(frame_dir, name_fmt.format(int(i))) for i in frame_ids]
    try:
        if out_hw is None:
            h, w = native.jpeg_dims(paths[0])
        else:
            h, w = out_hw
        return native.decode_jpeg_batch(paths, h, w)
    except native.NativeUnavailable:
        from PIL import Image

        imgs = []
        for p in paths:
            im = Image.open(p).convert("RGB")
            if out_hw is not None:
                im = im.resize((out_hw[1], out_hw[0]), Image.BILINEAR)
            imgs.append(np.asarray(im))
        return np.stack(imgs)
