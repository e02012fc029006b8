"""``ops/divided_attention.py`` and ``csrc/`` (K1, K2) in the narrator's
tower, at its 336 px grid (T = 4, N = 576, 577-row frames): the divided
attention's least time for the traced clips (``counts/attention.py`` on
the configuration's ``visual`` group) over the device time of the tower's
own attention kernels (the program's divided-attention symbols, the first
four of ``_shared.ATTENTION_KERNELS``), in percent. The decode steps'
attention is left out: ``decode_attn_roofline.narrate`` reads it. None
without such kernels (a CPU run)."""

from hhbench.counts.attention import ELEMENT_BYTES, tower_least_seconds_per_clip
from hhbench.metrics._shared import ATTENTION_KERNELS

TOWER = ATTENTION_KERNELS[:4]  # K1/K2 and K6, in bf16 and f32


def read(run):
    tr = run.trace_data
    dtype = run.cfg["precision"]["visual"]
    if tr is None or not run.traced_items or dtype not in ELEMENT_BYTES:
        return None
    seconds = tr.device_seconds(lambda n: any(k in n for k in TOWER))
    if not seconds:
        return None
    return 100.0 * tower_least_seconds_per_clip(run.cfg["visual"], dtype, run.peaks()) * run.traced_items / seconds
