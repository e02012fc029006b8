"""Profiling: a device trace of a stretch of the training loop, its op
table, and a steps-per-second meter.

Counterpart of ``helping_hand_for_egocentric_videos_tpu/utils/profiling.py``
on ``torch.profiler``. ``trace`` records the host and, on a CUDA device,
the kernels, written as a Chrome trace (``trace.json``, viewable in
Perfetto or chrome://tracing) into ``log_dir``; ``top_ops`` reads that
file back into a (self time, host or device, name) table, headless, as
the JAX package's ``top_ops`` reads its xprof capture; ``StepTimer`` is
the reference's steps/s meter (run/train.py:219).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

__all__ = ["trace", "top_ops", "StepTimer"]

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
    """Trace the body and write ``log_dir/trace.json``. ``device`` is
    waited for before the window opens and before it closes, and
    ``TRACE_MARGIN_S`` seconds of idle host time lie between each edge and
    the body, so that every device event of the body falls inside the
    window."""
    import torch
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


class StepTimer:
    """Steps-per-second meter with warmup skip (device/sps parity,
    run/train.py:219)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.start = None

    def tick(self):
        self.count += 1
        if self.count == self.warmup:
            self.start = time.perf_counter()

    @property
    def steps_per_sec(self) -> float:
        if self.start is None or self.count <= self.warmup:
            return 0.0
        return (self.count - self.warmup) / (time.perf_counter() - self.start)
