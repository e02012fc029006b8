"""Tiny widths of the benchmark's configurations, for CPU rehearsals of
the drivers (the kernels' plain versions run on CPU tensors)."""

from __future__ import annotations

import copy
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from hhbench import harness  # noqa: E402

VISUAL = {"img_size": 224, "patch_size": 32, "in_chans": 3, "width": 128, "depth": 2, "heads": 4, "mlp_ratio": 4,
          "ln_eps": 1e-6}
TEXT = {"vocab_size": 49408, "context_length": 77, "width": 64, "heads": 4, "layers": 2, "ln_eps": 1e-5}
DECODER = {"d_model": 64, "nhead": 4, "num_layers": 2, "dim_feedforward": 128, "num_classes": 10,
           "feature_dim": 128, "text_width": 64, "embed_dim": 32, "patches_per_frame": 49}

# CPU sizes of each traffic's parameters
PARAMS = {
    "store_b64": {"batch": 4, "chunks": 2, "chunk_frames": 96, "frame_hw": [48, 64], "dataset_clips": 100000,
                  "check_clips": 4},
    "step_b16": {"batch": 4, "pool": 4},
    "open_r80": {"rate": 20.0, "check_requests": 4, "clip_pool": 8, "buckets": [1, 2, 4, 8]},
}


# The serving cell is not in BENCHMARK.json (PERF.md, section 7); its driver, traffic and readers
# stay for a later cell and are rehearsed under the entries that BENCHMARK.json would give it.
SERVE = "serve16.open_r80"
SERVE_LAYER = "serve/engine.py (bucketing, micro-batching)"
SERVING = {
    "workloads": [{"name": SERVE, "config": "hh-tsf-l14-16f", "traffic": "open_r80", "chips": 1,
                   "why": "a retrieval service at ~80% of capacity"}],
    "end_to_end": [{"name": "serve_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25, "source": "host_clock",
                    "workloads": [SERVE]}],
    "per_layer": [
        {"name": "serve_pad_share", "unit": "%", "better": "lower", "source": "program_counter",
         "layer": SERVE_LAYER, "moves": "serve_p95_ms", "workloads": [SERVE]},
        {"name": "serve_clips_per_call", "unit": "clips", "better": "higher", "source": "program_counter",
         "layer": SERVE_LAYER, "moves": "serve_p95_ms", "workloads": [SERVE]},
        {"name": "device_idle_share.serve", "unit": "%", "better": "lower", "source": "device_trace",
         "layer": "the device", "moves": "serve_p95_ms", "workloads": [SERVE]},
    ],
}


def bench() -> dict:
    """BENCHMARK.json with the serving cell's entries added."""
    out = harness.read_json(harness.ROOT / "BENCHMARK.json")
    return {k: v + SERVING.get(k, []) if isinstance(v, list) else v for k, v in out.items()}


def tiny_cfg(cfg: dict, frames: int = 4) -> dict:
    out = copy.deepcopy(cfg)
    out["visual"] = dict(VISUAL, num_frames=frames)
    out["text"] = dict(TEXT)
    out["decoder"].update(DECODER, num_frames=frames)
    out["embed_dim"] = DECODER["embed_dim"]
    return out


def tiny_run(cell_name: str, *, seed: int = 7, seconds: float = 1.0, trace: bool = False, params=None,
             frames: int = 4) -> harness.Run:
    cell = harness.load_cell(cell_name, bench())
    cell = dataclasses.replace(cell, cfg=tiny_cfg(cell.cfg, frames),
                               params={**cell.params, **PARAMS[cell.traffic_name], **(params or {})})
    return harness.Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device="cpu")
