"""Profiling: a device trace of a stretch of the program, its op table,
and the program's own spans.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/utils/profiling.py``
on ``torch.profiler``. ``trace`` records the host and, on a CUDA device,
the kernels, written as a Chrome trace (``trace.json``, viewable in
Perfetto or chrome://tracing) into ``log_dir``, with the spans' table
beside it (``spans.json``); ``top_ops`` reads the trace back into a (self
time, host or device, name) table, headless, as the JAX package's
``top_ops`` reads its xprof capture.

``span(name, device)`` marks one of the program's layers where its work
happens (the names and their layers: ``SPANS``). With no torch profiler
running it is one shared null context: no range, no clock read. Under a
profiler it opens a ``record_function`` range, which the Chrome trace
shows on the kernels' clock when it runs on the profiler's thread (ranges
on other threads are dropped by the profiler), and adds its count and
host seconds, and on a CUDA ``device`` the time between a pair of CUDA
events on the current stream, to a table that works on any thread.
``spans()`` reads that table for the latest profiler session. The table
is the process's, as the profiler it follows is.

``count(name, n)`` adds ``n`` to a counter of that table (the names and
what they count: ``COUNTERS``), under a profiler only; ``spans()`` gives
its sum as ``count``, with no time.

The kernels' timers, on a CUDA device: ``cuda_ms`` times back-to-back
calls with CUDA events; ``device_ms`` reads the named kernels' own device
time from a ``torch.profiler`` trace of the calls (``kernel_events``,
``named_kernels``).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function

__all__ = ["COUNTERS", "SPANS", "active", "count", "cuda_ms", "device_ms", "kernel_events", "named_kernels", "span", "spans",
           "trace", "top_ops"]

# Every span's name and the layer it marks. The step's five phases (the
# backbone's graph replay nested in its phase), the eval forward's three and
# the narrator's run on the caller's thread, so a trace taken there holds
# their ranges; ``hh.data.item`` runs in the loader's decode threads, where
# only its count and host seconds are kept. ``hh.narrate.decode.attn`` runs
# inside ``hh.narrate.decode`` where a step runs eagerly, not where it
# replays a CUDA graph (``models/gpt2.py::Decoder``).
SPANS = {
    "hh.step.backbone": "models/lavila.py (the frozen visual and text towers)",
    "hh.step.backbone.replay": "train/step.py (the host's launch path: the towers replayed from a CUDA graph)",
    "hh.step.decoder": "models/obj_decoder.py (decoder_forward, txt_proj, obj_proj)",
    "hh.step.losses": "losses/ and ops/lap.py (EgoNCE, the box matchings, the word loss)",
    "hh.step.backward": "autograd (the step's backward)",
    "hh.step.optim": "train/step.py (gradient averaging, global norm, clip, AdamW)",
    "hh.eval.preprocess": "ops/preprocess.py (resize_normalize, crops)",
    "hh.eval.tower": "models/spacetime_vit.py (the visual tower)",
    "hh.eval.decoder": "models/obj_decoder.py (decoder_forward, txt_proj, obj_proj)",
    "hh.data.item": "data/ (PrefetchLoader, read_clip_chunked, pinned_put)",
    "hh.narrate.tower": "models/narrator.py (the preprocess and the visual tower at 336 px)",
    "hh.narrate.prefill": "models/narrator.py (GPT-2: the attention pooler, each cross layer's keys and values; "
                          "Kimi-VL: the projector and the prefix's latents, models/kimi_lm.py::prefill)",
    "hh.narrate.decode": "models/gpt2.py, models/kimi_lm.py (a decode step's blocks and lm_head)",
    "hh.narrate.decode.attn": "models/gpt2.py (an eager decode step's self- and cross-attention calls)",
    "hh.narrate.sample": "ops/sampling.py (temperature, top-p, the draw)",
    "hh.narrate.moe": "models/kimi_lm.py (an eager expert layer: the router, the sort, the grouped GEMMs)",
}

# Every counter's name and what it counts, summed over a profiler session.
COUNTERS = {
    "hh.narrate.decode_steps": "decode steps run (one token of every sequence of a batch)",
    "hh.narrate.tokens": "tokens drawn",
    "hh.narrate.sample_kernel_rows": "rows drawn by the hand-written sampler kernel (ops/sampling.py, csrc/nucleus_sample.cu)",
    "hh.narrate.decode_attn_kernel_calls": "decode attention calls made by the hand-written kernel (ops/decode_attention.py, csrc/decode_attention.cu), replayed ones included",
    "hh.narrate.self_cache_bytes": "bytes of the self-attention caches allocated, one a narrated batch",
    "hh.narrate.cross_cache_bytes": "bytes of the cross-attention caches allocated, one a narrated batch",
    "hh.narrate.expert_rows": "token-expert rows routed to Kimi-VL's experts (tokens x 6 a MoE layer), prefill and decode",
    "hh.narrate.experts_hit": "distinct routed experts hit, summed over the MoE layers of every decode step (read from the device under a profiler only)",
}

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_table: dict = {}  # name -> {"count", "host_s", "kind", "device_s", "events"}
# set by every span with no profiler running; the first span that records
# under a profiler clears the previous session's table and resets it
_new_session = True


def span(name: str, device=None):
    """A context manager around one layer's work (module docstring).
    ``device``: where the work runs; on a CUDA device the span also times
    the current stream with a pair of CUDA events. The body's results are
    the same with and without a profiler."""
    global _new_session
    if not _autograd_profiler._is_profiler_enabled:
        _new_session = True
        return _NULL
    return _Span(name, device)


def active() -> bool:
    """Whether a torch profiler runs: what ``span`` and ``count`` record
    under. Work that only feeds a counter is done under it alone."""
    return bool(_autograd_profiler._is_profiler_enabled)


def _entry(name: str, kind) -> dict:
    """``name``'s row of the table (the caller holds ``_lock``), the previous
    session's table cleared first where a new session began."""
    global _new_session
    if _new_session:
        _table.clear()
        _new_session = False
    return _table.setdefault(name, {"count": 0, "host_s": 0.0, "kind": kind, "device_s": 0.0, "events": []})


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` (``COUNTERS``) under a profiler; with
    none, nothing but the mark that a session has ended, as ``span``."""
    global _new_session
    if not _autograd_profiler._is_profiler_enabled:
        _new_session = True
        return
    with _lock:
        _entry(name, None)["count"] += int(n)


class _Span:
    __slots__ = ("name", "kind", "stream", "range", "start", "t0")

    def __init__(self, name: str, device):
        self.name = name
        dev = None if device is None else torch.device(device)
        self.kind = None if dev is None else dev.type
        self.stream = torch.cuda.current_stream(dev) if self.kind == "cuda" else None

    def __enter__(self):
        with _lock:
            _entry(self.name, self.kind)
        self.range = record_function(self.name)
        self.range.__enter__()
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_s = time.perf_counter() - self.t0
        pair = None
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            pair = (self.start, end)
        self.range.__exit__(*exc)
        with _lock:
            e = _entry(self.name, self.kind)
            e["count"] += 1
            e["host_s"] += host_s
            if pair is not None:
                e["events"].append(pair)
        return False


def spans() -> dict:
    """{name: {"count", "host_s", "device_s"}} of the spans that ran in the
    latest profiler session: from the first span that recorded after a
    span ran with no profiler, that is after the program ran untraced.
    ``device_s``: on a CUDA device the summed time between each span's
    pair of CUDA events (this waits for them), on the CPU the host
    seconds, and None for a span given no device."""
    out = {}
    with _lock:
        for name, e in _table.items():
            for start, end in e["events"]:
                end.synchronize()
                e["device_s"] += start.elapsed_time(end) / 1e3
            e["events"].clear()
            device_s = {"cuda": e["device_s"], None: None}.get(e["kind"], e["host_s"])
            out[name] = {"count": e["count"], "host_s": e["host_s"], "device_s": device_s}
    return out


# the trace's event categories: kernels and copies on the device; operators
# and the CUDA API's calls on the host
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "cuda_runtime", "cuda_driver")


# Idle host time that opens and closes a traced window. Late in a long
# process a window that opened on the first call lost device events at its
# edges (7 of 20 kernels kept: PERF.md section 6, C2); these margins keep
# them all.
TRACE_MARGIN_S = 0.25


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Trace the body and write ``log_dir/trace.json`` and the spans that
    ran in it, ``log_dir/spans.json`` (``spans()``). ``device`` is
    waited for before the window opens and before it closes, and
    ``TRACE_MARGIN_S`` seconds of idle host time lie between each edge and
    the body, so that every device event of the body falls inside the
    window."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        time.sleep(TRACE_MARGIN_S)
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
        time.sleep(TRACE_MARGIN_S)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(spans(), f, indent=1, sort_keys=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls,
    between two CUDA events, after one call outside them."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# A trace of the device often drops the record of the first kernel in its
# window (33 of 36 windows on an H100 under torch 2.11), so
# ``kernel_events`` opens each window with a few launches of this kernel of
# PyTorch's (``torch.cuda._sleep``) and leaves them out of what it returns.
_SENTINEL, _SENTINELS = "spin_kernel", 4


def kernel_events(fn, iters: int, margin_s: float = TRACE_MARGIN_S) -> list:
    """``key_averages()`` of a ``torch.profiler`` trace of the device over
    ``iters`` calls of ``fn``, after one call outside it; ``margin_s``
    seconds of idle host time open and close the traced window, and the
    sentinel launches that come first in it are left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        for _ in range(_SENTINELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(margin_s)
    return [e for e in prof.key_averages() if _SENTINEL not in e.key]


def named_kernels(events, kernels) -> tuple[int, float]:
    """(launches, device us) of the events whose names contain one of
    ``kernels`` (a string or a tuple of them)."""
    kernels = (kernels,) if isinstance(kernels, str) else kernels
    hits = [e for e in events if any(k in e.key for k in kernels)]
    us = sum(float(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total) for e in hits)
    return sum(e.count for e in hits), us


# Traces ``device_ms`` takes before it gives up on one that holds every
# launch: now and then a trace holds no kernel at all (one window in 36 on
# an H100 under torch 2.11).
TRACE_TRIES = 3


def device_ms(fn, iters: int, kernels, per_call: int = 1) -> float:
    """Mean device time in ms of the kernels whose names contain one of
    ``kernels`` (a string or a tuple of them) over ``iters`` calls of ``fn``,
    each of which launches ``per_call`` of them (K3: its attention and row
    passes), from a ``torch.profiler`` trace: the kernels alone.
    Back-to-back calls timed with events (``cuda_ms``) measure the host
    instead where the wrapper's host time exceeds a short kernel's (K4).
    A trace that holds another number of their launches than ``per_call *
    iters`` is never read (one that lost events would read low): the calls
    are traced again, and after ``TRACE_TRIES`` such traces it raises."""
    for _ in range(TRACE_TRIES):
        launches, us = named_kernels(kernel_events(fn, iters), kernels)
        if launches == per_call * iters:
            return us / iters / 1e3
    raise RuntimeError(f"the last of {TRACE_TRIES} traces held {launches} launches of kernels named like {kernels!r} "
                       f"over {iters} calls that launch {per_call} each: they lost events, or the calls launch others")


def _self_us(events) -> list[float]:
    """Each event's duration less its direct children's on the same
    thread (events nest by time on a thread; device events do not nest)."""
    out = [float(e["dur"]) for e in events]
    by_thread = defaultdict(list)
    for i, e in enumerate(events):
        by_thread[(e.get("pid"), e.get("tid"))].append(i)
    for idx in by_thread.values():
        stack = []
        for i in sorted(idx, key=lambda i: (events[i]["ts"], -events[i]["dur"])):
            e = events[i]
            while stack and e["ts"] >= events[stack[-1]]["ts"] + events[stack[-1]]["dur"]:
                stack.pop()
            if stack:
                out[stack[-1]] -= float(e["dur"])
            stack.append(i)
    return out


def top_ops(log_dir: str, k: int = 15):
    """Returns [(self_time_ms, "device" | "host", name), ...] descending,
    the ``k`` largest, from ``log_dir/trace.json`` (``trace``'s output):
    each kernel or copy on the device, and each host operator or CUDA
    runtime call, summed by name over the trace. A host operator's self
    time excludes the operators and calls nested in it."""
    path = os.path.join(log_dir, "trace.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no trace.json under {log_dir}")
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in _DEVICE + _HOST and "dur" in e]
    totals: dict[tuple[str, str], float] = defaultdict(float)
    for e, us in zip(events, _self_us(events)):
        totals[("device" if e["cat"] in _DEVICE else "host", e["name"])] += us
    rows = sorted(((us / 1e3, where, name) for (where, name), us in totals.items()), key=lambda r: -r[0])
    return rows[:k]
