#!/usr/bin/env python3
"""Host stages of the PyTorch port's end-to-end input path, one at a time.

Counterpart of ``tools/host_profile.py``, on the port's copies of
``data/``. It times each stage of ``tools/torch_bench.py``'s end-to-end
workload (the chunked uint8 ``.npy`` store, 8-clip batches, 16 frames of
256 x 342) in one process:

  slice          the raw memory-mapped ``npy[ids]`` of a clip's frames
  item           the whole ``read_clip_chunked`` of an item
  items+collate  8 items one after another, then ``collate``
  loader_t1      ``PrefetchLoader`` with 1 thread, depth 2
  loader_t4      ``PrefetchLoader`` with 4 threads, depth 2 (the bench's)

and prints a line a stage (clips/s), then ``host_stage_breakdown``. It
needs no card. Run it on an otherwise idle host: each number is per core
and moves with contention.

    python3 tools/torch_host_profile.py [n_batches, default 24]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_bench  # noqa: E402
from helping_hand_for_egocentric_videos_torch.data.loader import PrefetchLoader, ShardedSampler, collate  # noqa: E402

B, FRAMES = torch_bench.E2E_B, torch_bench.FRAMES


def main(n_batches: int = 24) -> dict:
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths, frames = torch_bench.write_clip_store(tmp)
        n_items = B * n_batches
        dataset = torch_bench.NpyClips(paths, n_items)

        # warm the page cache so that every stage reads memory, not disk
        for p in paths:
            np.load(p + ".npy").sum()

        # -- raw mmap slice, the file opened again for each item
        ids = np.linspace(0, len(frames) - 1, FRAMES).astype(int)
        t0 = time.perf_counter()
        for i in range(n_items):
            _ = np.load(paths[i % len(paths)] + ".npy", mmap_mode="r")[ids]
        out["slice"] = n_items / (time.perf_counter() - t0)

        # -- the whole reader of an item
        t0 = time.perf_counter()
        for i in range(n_items):
            dataset[i]
        out["item"] = n_items / (time.perf_counter() - t0)

        # -- a batch's items one after another, then collate
        t0 = time.perf_counter()
        for bi in range(n_batches):
            collate([dataset[bi * B + j] for j in range(B)])
        out["items+collate"] = n_items / (time.perf_counter() - t0)

        # -- the loader at 1 and 4 threads
        for nt in (1, 4):
            loader = PrefetchLoader(dataset, ShardedSampler(n_items, B, shuffle=False, drop_last=True),
                                    num_threads=nt, depth=2)
            t0 = time.perf_counter()
            n_clips = sum(batch["video"].shape[0] for batch in loader)
            out[f"loader_t{nt}"] = n_clips / (time.perf_counter() - t0)

    for k, v in out.items():
        print(json.dumps({"stage": k, "clips_per_sec": round(v, 1)}), flush=True)
    print(json.dumps({"metric": "host_stage_breakdown", **{k: round(v, 1) for k, v in out.items()},
                      "cpus": os.cpu_count()}), flush=True)
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 24)
