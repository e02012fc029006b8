"""``ops/sampling.py`` and ``csrc/nucleus_sample.cu`` (K7 over Kimi-VL's
163840-word rows, its wide route): the least time of the traced batch's
draws (``counts.kimivl.sample_least_seconds``: every step's f32 logits read
once and an id a row written, at the card's bandwidth) over the device time
of the kernels named ``nucleus_sample_kernel``, in percent. None without
them (a CPU run)."""

from hhbench.counts.kimivl import sample_least_seconds

KERNEL = "nucleus_sample_kernel"


def read(run):
    tr = run.trace_data
    if tr is None or not run.traced_items:
        return None
    seconds = tr.device_seconds(lambda n: KERNEL in n)
    if not seconds:
        return None
    return 100.0 * sample_least_seconds(run.cfg, run.traced_items, run.peaks()) / seconds
