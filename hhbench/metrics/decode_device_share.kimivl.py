"""``models/kimi_lm.py`` (the decode steps: every layer, the experts and
``lm_head``): percent of the traced window in ``hh.narrate.decode``, timed
on the device by the span's CUDA events."""

from hhbench.metrics._program import device_share


def read(run):
    return device_share(run, "hh.narrate.decode")
