"""``models/narrator.py::project_visual`` and ``models/kimi_lm.py::prefill``
(the projector and each clip's prefix into the latent cache): percent of
the traced window in ``hh.narrate.prefill``, timed on the device by the
span's CUDA events."""

from hhbench.metrics._program import device_share


def read(run):
    return device_share(run, "hh.narrate.prefill")
