"""A device trace of a short steady stretch, and what the metrics read
from it.

``capture`` runs its body under ``torch.profiler`` (host and CUDA
activities) inside a ``hhb.traced_window`` range, with the device waited
for and ``MARGIN_S`` seconds of idle host time at each edge, so that every
device event of the body falls inside the trace (a window that opens on
the first call can lose launches at its edges). ``parse`` reads the
exported Chrome trace into a ``Trace``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

MARGIN_S = 0.25
WINDOW = "hhb.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
SMALL_GAP_US = 10.0


@contextlib.contextmanager
def capture(path: str, device):
    """Trace the body; the Chrome trace goes to ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        time.sleep(MARGIN_S)
        with record_function(WINDOW):
            yield
            if cuda:
                torch.cuda.synchronize(device)
        time.sleep(MARGIN_S)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)


@dataclass
class Trace:
    """Device events (name, start us, duration us) inside the traced
    window, the window (start, end) in us, and the host's events."""

    window: tuple
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def kernels(self):
        return [e for e in self.device if e[3] == "kernel"]

    def busy_intervals(self):
        """Merged (start, end) us of device activity, clipped to the window."""
        iv = sorted((max(s, self.window[0]), min(s + d, self.window[1])) for _, s, d, _ in self.device)
        merged = []
        for s, e in iv:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_seconds(self, match) -> float | None:
        """Summed device time of the kernels whose name ``match`` accepts;
        None when there is none."""
        durs = [d for n, _, d, cat in self.device if cat == "kernel" and match(n)]
        return sum(durs) / 1e6 if durs else None

    def top_device_ops(self, k: int = 10):
        tot: dict = defaultdict(float)
        for n, _, d, _ in self.device:
            tot[n] += d / 1e6
        return sorted(([n, s] for n, s in tot.items()), key=lambda r: -r[1])[:k]

    def idle_gaps(self, k: int = 10):
        """Idle device time inside the window, summed by what the host was
        doing at each gap's middle: the outermost ``hhb.*`` range and the
        innermost host operation there (gaps under ``SMALL_GAP_US`` are
        summed as launch gaps). The ``k`` largest sums, in seconds."""
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for s, e in busy for x in (s, e)] + [self.window[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        host = [h for h in self.host if h[0] != WINDOW]
        ts = np.array([h[1] for h in host], dtype=np.float64)
        end = ts + np.array([h[2] for h in host], dtype=np.float64)
        tot: dict = defaultdict(float)
        for s, e in gaps:
            if e - s < SMALL_GAP_US:
                tot[f"gaps under {SMALL_GAP_US:g} us"] += (e - s) / 1e6
                continue
            mid = 0.5 * (s + e)
            idx = np.nonzero((ts <= mid) & (end > mid))[0]
            spans = [host[i] for i in idx]
            outer = [h for h in spans if h[0].startswith("hhb.")]
            inner = [h for h in spans if not h[0].startswith("hhb.")]
            name = (max(outer, key=lambda h: h[2])[0] if outer else "outside hhb spans")
            if inner:
                name += " > " + min(inner, key=lambda h: h[2])[0]
            tot[name] += (e - s) / 1e6
        return sorted(([n, v] for n, v in tot.items()), key=lambda r: -r[1])[:k]


def parse(path: str) -> Trace:
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    wins = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not wins:
        raise RuntimeError(f"the trace {path} holds no {WINDOW} range")
    w = max(wins, key=lambda e: float(e["dur"]))
    window = (float(w["ts"]), float(w["ts"]) + float(w["dur"]))
    dev, host = [], []
    for e in events:
        cat, s, d = e.get("cat"), float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS and s + d > window[0] and s < window[1]:
            dev.append((e["name"], s, d, cat))
        elif cat in HOST_CATS and s + d > window[0] and s < window[1]:
            host.append((e["name"], s, d))
    return Trace(window=window, device=dev, host=host)
