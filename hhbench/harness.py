"""The harness: a cell's files, the run's clock and spans, the traced
stretch, the per-layer metric readers, the jax check and the result line.

A driver (``mixes/<driver>.py``) gets a ``Run``; it sets up, calls
``open_window()``, runs the window, calls ``close_window(items)``, runs
``traced()`` when the run traces, calls ``read_memory()``, frees what it
holds on the device and returns a ``Result`` whose ``check`` runs the
reference and returns each compared number by name.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "helping_hand_for_egocentric_videos_tpu")


def read_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def process_start_time() -> float:
    """The wall-clock time at which this process started (Linux
    ``/proc``), or now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    cfg: dict
    params: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def driver(self) -> str:
        return self.params["driver"]


def load_cell(name: str, bench: dict | None = None, root: Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files: its
    configuration, its traffic's parameters (the cell file's ``params``
    over the traffic file's), its limits, and the metrics it reports."""
    bench = read_json(root.parent / "BENCHMARK.json") if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    wf = read_json(root / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if wf[key] != entry[key]:
            raise SystemExit(f"workloads/{name}.json has {key}={wf[key]!r}, BENCHMARK.json {entry[key]!r}")
    traffic = read_json(root / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name=name, config_name=entry["config"], traffic_name=entry["traffic"], chips=int(entry["chips"]),
                cfg=read_json(root / "configs" / f"{entry['config']}.json"),
                params={**traffic, **wf.get("params", {})}, limits=wf["limits"], end_to_end=e2e,
                per_layer=per_layer)


class Spans:
    """Host-clock spans around calls into the program's layers: seconds
    and counts by name, summed while the window is open. Each span is also
    a ``record_function`` range, so a trace names it."""

    def __init__(self):
        self.seconds: dict = defaultdict(float)
        self.count: dict = defaultdict(int)
        self.on = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        from torch.profiler import record_function

        with record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self.on:
                    self.seconds[name] += time.perf_counter() - t0
                    self.count[name] += 1


@dataclass
class Result:
    """What a driver returns: each end-to-end metric's value by name, the
    requests or items attempted and failed, and ``check``, which runs the
    reference and returns {compared number's name: value}."""

    e2e: dict
    attempted: int
    failed: int
    check: Callable[[], dict]


@dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_process: float = field(default_factory=time.time)
    spans: Spans = field(default_factory=Spans)
    counters: dict = field(default_factory=dict)
    setup_s: float | None = None
    window_s: float | None = None
    items: int = 0
    traced_items: int = 0
    traced_steps: int = 0
    trace_data: object = None
    memory_peak: int | None = None
    _t_open: float = 0.0

    @property
    def cfg(self) -> dict:
        return self.cell.cfg

    @property
    def params(self) -> dict:
        return self.cell.params

    def open_window(self):
        self.setup_s = time.time() - self.t_process
        self.spans.seconds.clear()
        self.spans.count.clear()
        self.spans.on = True
        self._t_open = time.perf_counter()
        return self._t_open

    def elapsed(self) -> float:
        return time.perf_counter() - self._t_open

    def close_window(self, items: int):
        """The window's end: ``items`` done since ``open_window``, all of
        them finished on the device."""
        self.window_s = time.perf_counter() - self._t_open
        self.spans.on = False
        self.items = int(items)

    @contextlib.contextmanager
    def traced(self, items: int = 0, steps: int = 0):
        """Trace the body (when the run traces) and keep the parsed trace;
        ``items`` and ``steps``: the work the body does."""
        if not self.trace:
            yield
            return
        from . import trace as tr

        path = os.path.join(tempfile.gettempdir(), "hhbench", f"trace-{self.cell.name}-{os.getpid()}.json")
        try:
            with tr.capture(path, self.device):
                yield
            self.trace_data = tr.parse(path)
        finally:
            with contextlib.suppress(OSError):
                os.remove(path)
        self.traced_items, self.traced_steps = items, steps

    def read_memory(self):
        import torch

        dev = torch.device(self.device)
        self.memory_peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0

    def peaks(self) -> dict:
        """The card's published peaks (the SXM part's off the card)."""
        import torch

        from .counts.peaks import PEAKS, peaks_for

        dev = torch.device(self.device)
        return peaks_for(torch.cuda.get_device_name(dev)) if dev.type == "cuda" else PEAKS["sxm"]


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name, the part
    before the first dot, is JAX's or the JAX package's, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def load_metric(name: str, root: Path = HERE):
    """The reader ``metrics/<name>.py`` of a per-layer metric."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("hhbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str):
    return importlib.import_module(f"hhbench.mixes.{name}")


def drive(run: Run) -> Result:
    """The cell's driver on ``run``; a ``fault`` in the run's parameters
    (set by tests and ``calibrate.py`` only, never by a cell's files) is
    planted in the program for the duration (``faults.py``)."""
    from .faults import planted

    with planted(run.params.get("fault")):
        return load_driver(run.cell.driver).run(run)


def per_layer_values(run: Run, root: Path = HERE) -> dict:
    """Each of the cell's per-layer metrics that its reader finds
    something to read for; a reader that finds nothing returns None and
    the metric is left out."""
    out = {}
    for m in run.cell.per_layer:
        value = load_metric(m["name"], root).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def power_limit_w() -> float | None:
    """The card's power limit from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def judge(compared: dict, limits: dict) -> tuple[bool, dict]:
    """Every limited number present, finite and within its limit ->
    (correct, {name: {"value", "limit"}})."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = compared.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        out[name] = {"value": None if value is None else float(value), "limit": limit}
    return ok, out
