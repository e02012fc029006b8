"""``models/gpt2.py`` (decode attention over the self and cross caches):
the least time of the traced batches' decode attention
(``counts.narrator.decode_attn_least_seconds``: the caches' keys and
values and the queries and outputs at the card's bandwidth) over the
device time of the trace's attention kernels other than the tower's own
(``_shared.is_attention`` less the divided-attention kernels), in percent.
The decode steps replay from CUDA graphs, inside which the
``hh.narrate.decode.attn`` spans do not run, so the kernels are read from
the trace by name; the pooler's one attention call a batch is among them
(under 1% of their time). None without such kernels (a CPU run)."""

from hhbench.counts.narrator import decode_attn_least_seconds
from hhbench.metrics._shared import ATTENTION_KERNELS, is_attention

TOWER = ATTENTION_KERNELS[:4]  # K1/K2 and K6, in bf16 and f32


def read(run):
    tr = run.trace_data
    if tr is None or not run.traced_items:
        return None
    seconds = tr.device_seconds(lambda n: is_attention(n) and not any(k in n for k in TOWER))
    if not seconds:
        return None
    least = decode_attn_least_seconds(run.cfg, run.traced_items, run.cfg["precision"]["visual"], run.peaks())
    return 100.0 * least / seconds
