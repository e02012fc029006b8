"""``ops/preprocess.py`` (``EvalModel.preprocess_video``): percent of the
traced window in ``hh.eval.preprocess``, timed on the device by the
span's CUDA events."""

from hhbench.metrics._program import device_share


def read(run):
    return device_share(run, "hh.eval.preprocess")
