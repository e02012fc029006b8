"""Batching engine for online serving on a CUDA device.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/serve/engine.py``,
with the same buckets, micro-batching and health report:

1. Request batches are padded up to a fixed set of power-of-two BUCKETS,
   so the device only ever sees ``len(buckets)`` batch shapes per
   modality, and all of them can be warmed at startup (kernel build,
   library handles, allocator pools) before traffic arrives.
2. Device utilisation comes from batch, not concurrency — concurrent
   requests are coalesced by a dispatcher thread into one device call
   (micro-batching with a small deadline), then results are split back
   per request. The device itself is driven from that single thread;
   there is no contended device lock.

The engine is transport-agnostic: ``submit_text`` / ``submit_video``
block until the result is ready and are safe to call from any number of
threads (an HTTP handler pool in serve/server.py, a queue consumer,
etc.).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["ServeConfig", "ServingEngine"]


@dataclass(frozen=True)
class ServeConfig:
    buckets: tuple = (1, 2, 4, 8, 16)
    # dispatcher deadline: how long to hold an under-filled batch open
    # for coalescing before running it anyway
    max_wait_ms: float = 4.0
    # buckets to run once at startup (both modalities); None = every
    # configured bucket — no live request pays first-use set-up only
    # when all buckets a request can land in are warmed
    warmup_buckets: tuple | None = None
    # a device call older than this marks health() "device_stalled": a
    # hung device call blocks the dispatcher, so an external watchdog
    # must learn it from /healthz, which therefore must never itself
    # touch the device
    stall_threshold_s: float = 120.0


class _Pending:
    """One submitted request: items + a slot the dispatcher fills."""

    __slots__ = ("items", "t_submit", "done", "result", "error")

    def __init__(self, items):
        self.items = items
        self.t_submit = time.perf_counter()
        self.done = threading.Event()
        self.result = None
        self.error = None


@dataclass
class _Stats:
    """One modality's counts. ``queue_wait_s``: the summed time from each
    request's submission to the dispatcher taking it off the queue
    (``queue_wait_max_s`` the longest); ``device_s``: the time spent in the
    model's device calls, each ending with its results on the host."""

    requests: int = 0
    items: int = 0
    device_calls: int = 0
    padded_items: int = 0
    queue_wait_s: float = 0.0
    queue_wait_max_s: float = 0.0
    device_s: float = 0.0
    lock: threading.Lock = field(default_factory=threading.Lock)

    def snapshot(self) -> dict:
        with self.lock:
            return {
                "requests": self.requests,
                "items": self.items,
                "device_calls": self.device_calls,
                "padded_items": self.padded_items,
                "queue_wait_s": self.queue_wait_s,
                "queue_wait_max_s": self.queue_wait_max_s,
                "device_s": self.device_s,
            }


class ServingEngine:
    """Micro-batching dual-encoder server core over an ``EvalModel``.

    video_shape: the deployment's fixed (T, H, W, C) clip shape —
    resolution is a deploy-time constant, not a per-request degree of
    freedom. The engine serves on the model's device (``model.device``;
    a model without one means the CUDA device, which must exist).
    """

    def __init__(self, model, video_shape: tuple, cfg: ServeConfig = ServeConfig()):
        if str(getattr(model, "preprocess", "resize")).startswith("crops"):
            # multi-crop TTA returns crop-major (k*B, E) rows — items are
            # not contiguous, so per-request splitting is undefined (the
            # eval harnesses reject it the same way)
            raise ValueError("multi-crop TTA preprocess is not servable")
        self.model = model
        self.cfg = cfg
        self.video_shape = tuple(video_shape)
        self.buckets = tuple(sorted(cfg.buckets))
        self.stats = {"text": _Stats(), "video": _Stats()}
        self._queues = {"text": [], "video": []}
        self._cv = threading.Condition()
        self._closed = False
        # device identity is captured ONCE here; health() must stay
        # device-free so it keeps answering when the device wedges
        device = resolve_device(getattr(model, "device", None))
        self._backend = device.type
        self._n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
        self._last_device_done = time.time()
        self._device_busy_since: float | None = None
        self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ public
    def submit_text(self, texts: list[str]) -> np.ndarray:
        """-> (len(texts), E) f32 embeddings. Blocks; thread-safe."""
        if not len(texts):
            raise ValueError("empty texts")
        tokens = np.asarray(self.model.tokenizer(list(texts)))
        return self._submit("text", tokens)

    def submit_video(self, video_u8: np.ndarray):
        """video_u8 (B, T, H, W, C) uint8 at the deployment clip shape
        -> ((B, E) embeddings, (B, ...) predicted boxes). Blocks."""
        video_u8 = np.asarray(video_u8)
        if not len(video_u8):
            raise ValueError("empty video batch")
        if video_u8.shape[1:] != self.video_shape:
            raise ValueError(
                f"clip shape {video_u8.shape[1:]} != deployment shape "
                f"{self.video_shape} (fixed per serving config)"
            )
        if video_u8.dtype != np.uint8:
            # a float payload would silently double-normalize
            raise ValueError(f"video dtype {video_u8.dtype} != uint8 (0..255)")
        return self._submit("video", video_u8)

    def warmup(self):
        """Run the warmup buckets (default: every configured bucket) once,
        so no live request pays the kernel build or first-use set-up.
        Call once at startup."""
        t, h, w, c = self.video_shape
        for b in self.cfg.warmup_buckets or self.buckets:
            self.submit_text(["warmup"] * b)
            self.submit_video(np.zeros((b, t, h, w, c), np.uint8))

    def health(self) -> dict:
        """Engine + device-liveness status. Deliberately touches NO device
        API: when the device hangs, in-flight device calls block forever —
        this must keep answering so an external watchdog can see
        ``device_busy_s`` grow past the stall threshold."""
        now = time.time()
        busy_since = self._device_busy_since
        busy_s = (now - busy_since) if busy_since is not None else 0.0
        stalled = busy_s > self.cfg.stall_threshold_s
        return {
            "status": "device_stalled" if stalled else "ok",
            "backend": self._backend,
            "devices": self._n_devices,
            "device_busy_s": round(busy_s, 3),
            "last_device_call_age_s": round(now - self._last_device_done, 3),
            "video_shape": list(self.video_shape),
            "buckets": list(self.buckets),
            "int8": bool(getattr(self.model, "int8", False)),
            "stats": {k: s.snapshot() for k, s in self.stats.items()},
        }

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    # -------------------------------------------------------- dispatcher
    def _submit(self, kind: str, items: np.ndarray):
        st = self.stats[kind]
        with st.lock:
            st.requests += 1
            st.items += len(items)
        req = _Pending(items)
        with self._cv:
            if self._closed:
                raise RuntimeError("engine closed")
            self._queues[kind].append(req)
            self._cv.notify_all()
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _dispatch_loop(self):
        deadline_s = self.cfg.max_wait_ms / 1e3
        while True:
            with self._cv:
                while not self._closed and not any(self._queues.values()):
                    self._cv.wait()
                if self._closed and not any(self._queues.values()):
                    return
                pending = max(
                    sum(len(r.items) for r in q) for q in self._queues.values()
                )
            # hold an under-filled batch open briefly so concurrent
            # callers coalesce; with a full bucket (or backlog) already
            # queued the deadline buys nothing — dispatch immediately
            if pending < self.buckets[-1]:
                time.sleep(deadline_s)
            for kind in ("text", "video"):
                batch = []
                n = 0
                with self._cv:
                    q = self._queues[kind]
                    while q and n + len(q[0].items) <= self.buckets[-1]:
                        r = q.pop(0)
                        batch.append(r)
                        n += len(r.items)
                    # an oversized single request is chunked by the caller
                    # path below rather than starving the queue
                    if not batch and q:
                        batch.append(q.pop(0))
                        n = len(batch[0].items)
                if batch:
                    now = time.perf_counter()
                    st = self.stats[kind]
                    with st.lock:
                        for r in batch:
                            st.queue_wait_s += now - r.t_submit
                            st.queue_wait_max_s = max(st.queue_wait_max_s, now - r.t_submit)
                    self._run(kind, batch, n)

    def _run(self, kind: str, batch: list, n: int):
        self._device_busy_since = time.time()
        try:
            items = np.concatenate([r.items for r in batch])
            outs = []
            # chunk oversized loads at the largest bucket
            step = self.buckets[-1]
            calls = 0
            padded = 0
            device_s = 0.0
            for lo in range(0, len(items), step):
                part = items[lo : lo + step]
                b = self._bucket(len(part))
                pad = b - len(part)
                if pad:
                    part = np.concatenate(
                        [part, np.repeat(part[-1:], pad, axis=0)]
                    )
                keep = b - pad
                t0 = time.perf_counter()
                if kind == "text":
                    outs.append((self.model.embed_tokens(part)[:keep],))
                else:
                    emb, boxes = self.model.embed_video(part)
                    # pred_boxes rows can be per FRAME (leading dim B*T
                    # under pred_traj) — trim padding by the
                    # rows-per-clip factor, not the clip count
                    f = boxes.shape[0] // b
                    outs.append((emb[:keep], boxes[: keep * f]))
                device_s += time.perf_counter() - t0
                calls += 1
                padded += pad
            st = self.stats[kind]
            with st.lock:
                st.device_calls += calls
                st.padded_items += padded
                st.device_s += device_s
            parts = [np.concatenate([o[i] for o in outs]) for i in range(len(outs[0]))]
            # per-request split: each output's rows-per-item factor (1
            # for embeddings; T for the per-frame pred_boxes)
            factors = [p.shape[0] // len(items) for p in parts]
            lo = 0
            for r in batch:
                hi = lo + len(r.items)
                r.result = (
                    parts[0][lo:hi]
                    if kind == "text"
                    else tuple(
                        p[lo * f : hi * f] for p, f in zip(parts, factors)
                    )
                )
                lo = hi
                r.done.set()
        except Exception as e:  # surface to every waiter, keep serving
            for r in batch:
                r.error = e
                r.done.set()
        finally:
            self._last_device_done = time.time()
            self._device_busy_since = None
