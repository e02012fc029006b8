"""Profiling: a device trace of a stretch of the training loop.

Counterpart of ``trace`` in
``helping_hand_for_egocentric_videos_tpu/utils/profiling.py`` on
``torch.profiler``: the host and, on a CUDA device, the kernels, written
as a Chrome trace (``trace.json``, viewable in Perfetto or
chrome://tracing) into ``log_dir``. The JAX module's ``top_ops`` and
``StepTimer`` are not ported yet.
"""

from __future__ import annotations

import contextlib
import os

__all__ = ["trace"]


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Trace the body; on exit, wait for ``device`` and write
    ``log_dir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
