"""``models/gpt2.py`` (the decode steps): launch calls inside the
``hh.narrate.decode`` ranges, over the decode steps traced: kernel
launches, and on the card the CUDA graph launches that replay a step."""

import numpy as np

from hhbench.metrics._program import LAUNCHES

CALLS = LAUNCHES + ("cudaGraphLaunch", "cuGraphLaunch")


def read(run):
    tr = run.trace_data
    if tr is None or not run.traced_steps:
        return None
    ranges = [(s, s + d) for n, s, d in tr.host if n == "hh.narrate.decode"]
    starts = np.sort(np.array([s for n, s, _ in tr.host if n in CALLS], dtype=np.float64))
    if not ranges or not starts.size:
        return None
    n = sum(int(np.searchsorted(starts, e) - np.searchsorted(starts, s)) for s, e in ranges)
    return n / run.traced_steps
