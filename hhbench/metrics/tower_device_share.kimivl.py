"""``models/spacetime_vit.py`` (the visual tower at 336 px, with the
preprocess), under Kimi-VL's language model: percent of the traced window
in ``hh.narrate.tower``, timed on the device by the span's CUDA events."""

from hhbench.metrics._program import device_share


def read(run):
    return device_share(run, "hh.narrate.tower")
