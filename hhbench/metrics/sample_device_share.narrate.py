"""``ops/sampling.py`` (temperature, top-p, the draw): percent of the
traced window in ``hh.narrate.sample``, timed on the device by the span's
CUDA events."""

from hhbench.metrics._program import device_share


def read(run):
    return device_share(run, "hh.narrate.sample")
