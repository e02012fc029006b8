"""Frame-index samplers.

Host-side numpy samplers with semantics matching the reference's
(base/base_dataset.py:178-245): segment-uniform / segment-random sampling
over a frame range. All randomised variants take an explicit
``np.random.Generator`` so per-epoch shuffling is reproducible and
per-worker independent (the reference uses the global ``random`` module).

Documented divergences (oracle-tested on every deterministic path,
tests/test_reference_parity.py::test_frame_samplers_match_reference_functions):
``fix_start`` takes precedence here regardless of ``sample`` (the
reference checks ``sample=='rand'`` first, so its ``fix_start`` is dead
with the default mode), and ``sample_frames``'s rand path guards
degenerate one-frame segments (the reference's ``random.choice(range(x,
x))`` raises on them).

A copy of ``helping_hand_for_egocentric_videos_tpu/data/samplers.py`` (the port imports
nothing of the JAX package); it runs on the host without JAX, so the same inputs and seed give
the same result in both packages.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "sample_frames",
    "sample_frames_start_end",
    "sample_frames_clips",
    "get_frame_ids",
]


def _ranges(start: int, stop: int, n: int):
    intervals = np.linspace(start=start, stop=stop, num=n + 1).astype(int)
    return [(intervals[i], intervals[i + 1] - 1) for i in range(n)]


def sample_frames(num_frames: int, vlen: int, sample: str = "rand", fix_start=None, rng=None):
    """Segment sampling over [0, vlen) (base_dataset.py:178-193)."""
    acc = min(num_frames, vlen)
    ranges = _ranges(0, vlen, acc)
    if fix_start is not None:
        return [x[0] + fix_start for x in ranges]
    if sample == "rand":
        rng = rng or np.random.default_rng()
        return [int(rng.integers(x[0], max(x[1], x[0] + 1))) for x in ranges]
    if sample == "uniform":
        return [(x[0] + x[1]) // 2 for x in ranges]
    raise NotImplementedError(sample)


def sample_frames_start_end(
    num_frames: int, start: int, end: int, sample: str = "rand", fix_start=None, rng=None
):
    """Segment sampling over [start, end] (base_dataset.py:221-245),
    including its exact-length special case (end - start + 1 == n uses an
    inclusive stop)."""
    acc = min(num_frames, end)
    stop = end + 1 if (end - start + 1 == num_frames) else end
    ranges = _ranges(start, stop, acc)
    if fix_start is not None:
        return [x[0] + fix_start for x in ranges]
    if sample == "rand":
        rng = rng or np.random.default_rng()
        out = []
        for x in ranges:
            out.append(x[0] if x[1] == x[0] else int(rng.integers(x[0], x[1])))
        return out
    if sample == "uniform":
        return [(x[0] + x[1]) // 2 for x in ranges]
    raise NotImplementedError(sample)


def sample_frames_clips(start: int, end: int, vlen: int, acc_samples: int):
    """Uniform midpoints over [max(0,start), min(vlen,end)]
    (base_dataset.py:195-205)."""
    start = max(0, start)
    end = min(vlen, end)
    return [(x[0] + x[1]) // 2 for x in _ranges(start, end, int(acc_samples))]


def get_frame_ids(
    start_frame: int, end_frame: int, num_segments: int = 32, jitter: bool = True, rng=None
):
    """LaviLa-style rounded segment sampling (base_dataset.py:207-219);
    the EgoClip chunked reader uses jitter=False."""
    seg_size = float(end_frame - start_frame - 1) / num_segments
    seq = []
    rng = rng or np.random.default_rng()
    for i in range(num_segments):
        start = int(np.round(seg_size * i) + start_frame)
        end = min(int(np.round(seg_size * (i + 1)) + start_frame), end_frame)
        if jitter:
            seq.append(int(rng.integers(start, end + 1)))
        else:
            seq.append((start + end) // 2)
    return seq
