"""``models/obj_decoder.py`` (the decoder and ``obj_proj``): percent of the
traced window in ``hh.eval.decoder``, timed on the device by the span's
CUDA events."""

from hhbench.metrics._program import device_share


def read(run):
    return device_share(run, "hh.eval.decoder")
