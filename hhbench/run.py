"""Run one cell of ``BENCHMARK.json`` on the CUDA devices of this machine.

    python3 hhbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``compared`` (each number that decides
``correct`` beside its limit; also the last lines of standard error).
Exits non-zero, printing no result, when the program is not in this
checkout, without enough CUDA devices, or when a JAX module is loaded once
the window has closed. Build and kernel caches stay inside the checkout.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hhbench import harness  # noqa: E402

T_PROCESS = harness.process_start_time()

CACHE = ROOT / "build" / "hhbench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)


def parse_args(argv):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = harness.load_cell(args.workload)
    try:  # the program measured is this checkout's, never an installed copy
        import helping_hand_for_egocentric_videos_torch as program
    except ImportError as e:
        print(f"hhbench: the program is not in this checkout: {e}", file=sys.stderr)
        return 5
    if Path(program.__file__).resolve().parent.parent != ROOT:
        print(f"hhbench: the program was imported from {program.__file__}, outside {ROOT}", file=sys.stderr)
        return 5
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"hhbench: {args.workload} needs {cell.chips} CUDA device(s), found {n}", file=sys.stderr)
        return 3
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device=torch.device("cuda", 0), t_process=T_PROCESS)
    line = execute(run)
    if line is None:
        return 4
    print(json.dumps(line), flush=True)
    return 0


def execute(run) -> dict | None:
    """Everything of a run after the look for the card: the driver, the
    JAX check (None when a JAX module is loaded), the outputs' check and
    the result line."""
    result = harness.drive(run)
    found = harness.forbidden_modules()
    if found:
        print(f"hhbench: JAX modules loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return None
    return emit(run, result)


def emit(run, result) -> dict:
    """Check the outputs, then assemble the result line."""
    import torch

    compared = result.check()
    correct, judged = harness.judge(compared, run.cell.limits)
    correct = correct and result.failed == 0
    if run.trace:
        metrics = harness.per_layer_values(run)
    else:
        metrics = {m["name"]: {"value": float(result.e2e[m["name"]]), "unit": m["unit"]}
                   for m in run.cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": float(run.setup_s), "unit": "s"}
    cuda = torch.device(run.device).type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": run.cell.chips, "memory_peak_bytes": int(run.memory_peak),
              "power_limit_w": harness.power_limit_w() if cuda else None}
    line = {"correct": bool(correct), "attempted": int(result.attempted), "failed": int(result.failed),
            "metrics": metrics, "device": device}
    if run.trace and run.trace_data is not None:
        device["busy_s"] = run.trace_data.busy_s
        device["window_s"] = run.trace_data.window_s
        line["breakdown"] = {"device_ops": run.trace_data.top_device_ops(),
                             "idle_gaps": run.trace_data.idle_gaps()}
    judged["failed"] = {"value": int(result.failed), "limit": 0}
    line["compared"] = judged
    for name, c in judged.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return line


if __name__ == "__main__":
    sys.exit(main())
