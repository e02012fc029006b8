"""``ops/sampling.py`` (temperature, top-p, the draw over 163840 words, K7's
wide route on the card) under Kimi-VL's language model: percent of the
traced window in ``hh.narrate.sample``, as ``sample_device_share.narrate``
reads it."""

from hhbench.harness import load_metric


def read(run):
    return load_metric("sample_device_share.narrate").read(run)
