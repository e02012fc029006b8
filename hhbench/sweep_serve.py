"""Find the highest rate a serving cell's traffic sustains: run the cell's
driver at each ``--rates`` on each ``--seeds`` for ``--seconds`` and
print, a run a line,
the 50th and 95th percentile latency, the median latency of the last third
of the requests over that of the first (a growing backlog reads well
above 1), the clips completed a second, and the engine's padding and
clips a call. Run once when a serving cell is defined; the cell then fixes
its rate. A cell that BENCHMARK.json does not list yet is read from its
workload file alone.

    python3 hhbench/sweep_serve.py --workload serve16.open_r80 --rates 14 18 22 --seeds 1 2 --seconds 30
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from hhbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--seeds", type=int, nargs="+", default=[1])
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("sweep_serve: no CUDA device", file=sys.stderr)
        return 3
    bench = harness.read_json(harness.ROOT / "BENCHMARK.json")
    if all(w["name"] != a.workload for w in bench["workloads"]):  # a cell not yet entered: its own file
        wf = harness.read_json(harness.HERE / "workloads" / f"{a.workload}.json")
        bench["workloads"].append({"name": a.workload, **{k: wf[k] for k in ("config", "traffic", "chips", "why")}})
    cell = harness.load_cell(a.workload, bench)
    for rate, seed in [(r, s) for s in a.seeds for r in a.rates]:
        run = harness.Run(cell=dataclasses.replace(cell, params=dict(cell.params, rate=rate)), seed=seed,
                          seconds=a.seconds, trace=False, device=torch.device("cuda", 0))
        res = harness.load_driver(cell.driver).run(run)
        compared = res.check()
        c = run.counters
        rows = c["items"] + c["padded_items"]
        print(json.dumps({"rate": rate, "seed": seed, "p95_ms": res.e2e["serve_p95_ms"], "latency_trend": c["latency_trend"],
                          "clips_per_s": run.items / run.window_s, "requests": res.attempted, "failed": res.failed,
                          "pad_share": 100.0 * c["padded_items"] / rows if rows else None,
                          "clips_per_call": c["items"] / c["device_calls"] if c["device_calls"] else None,
                          "generator_late_p95_ms": c["generator_late_p95_ms"], "setup_s": run.setup_s,
                          "compared": compared}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
