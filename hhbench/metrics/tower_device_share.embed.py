"""``models/spacetime_vit.py`` (the visual tower): percent of the traced
window in ``hh.eval.tower``, timed on the device by the span's CUDA
events."""

from hhbench.metrics._program import device_share


def read(run):
    return device_share(run, "hh.eval.tower")
