"""``models/kimi_lm.py::moe`` (the experts, routed and shared, as grouped
GEMMs): the least time of the traced batch's expert GEMMs
(``counts.kimivl.expert_least_seconds``: each call the larger of the bytes
of the groups it hits and its rows in and out at the card's bandwidth, and
its operations at the bf16 peak; the decode steps' rows and hits from the
program's counters ``hh.narrate.expert_rows`` and
``hh.narrate.experts_hit``) over the device time of the grouped-GEMM
kernels, read by name, in percent. None without the counters or the
kernels (a CPU run, or a program without them)."""

from hhbench.counts.kimivl import expert_least_seconds
from hhbench.metrics._program import table

# the kernels torch._grouped_mm launches on an H100: CUTLASS's GemmUniversal over a GroupProblemShape
GROUPED = "GroupProblemShape"


def read(run):
    tr = run.trace_data
    t = table(run) or {}
    hit, rows = t.get("hh.narrate.experts_hit"), t.get("hh.narrate.expert_rows")
    if tr is None or not run.traced_items or hit is None or rows is None:
        return None
    seconds = tr.device_seconds(lambda n: GROUPED in n)
    if not seconds:
        return None
    least = expert_least_seconds(run.cfg, run.traced_items, run.traced_steps, hit["count"], rows["count"],
                                 run.cfg["precision"]["lm"], run.peaks())
    return 100.0 * least / seconds
