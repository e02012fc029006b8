"""What the readers of the program's own spans share (the program's
``utils/profiling.py``: ``span``, ``spans``). A program without them (an
older one) leaves every such reader with nothing to read."""

from __future__ import annotations

import numpy as np

# The host's kernel-launch calls in a CUDA trace: the runtime's and the
# driver's (cuBLAS launches through the latter).
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def table(run) -> dict | None:
    """The program's span table of the traced stretch, {name: {"count",
    "host_s", "device_s"}}; None without a trace or where the program
    keeps none."""
    if run.trace_data is None:
        return None
    try:
        from helping_hand_for_egocentric_videos_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def launches_per_step(run, name: str):
    """Kernel-launch calls whose start lies inside a range ``name`` of the
    trace, over the steps traced. Containment is by time on the trace's
    one clock, not by thread, so that the launches of autograd's device
    thread count in the range that waits for them. None without such a
    range or without launch calls (a trace of the CPU)."""
    tr = run.trace_data
    if tr is None or not run.traced_steps:
        return None
    ranges = [(s, s + d) for n, s, d in tr.host if n == name]
    starts = np.sort(np.array([s for n, s, _ in tr.host if n in LAUNCHES], dtype=np.float64))
    if not ranges or not starts.size:
        return None
    n = sum(int(np.searchsorted(starts, e) - np.searchsorted(starts, s)) for s, e in ranges)
    return n / run.traced_steps


def device_share(run, name: str):
    """Percent of the traced window that the span ``name`` held the device:
    its summed CUDA-event time over the window."""
    e = (table(run) or {}).get(name)
    if e is None or e["device_s"] is None or run.trace_data.window_s <= 0:
        return None
    return 100.0 * e["device_s"] / run.trace_data.window_s
