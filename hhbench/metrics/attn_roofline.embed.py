"""``ops/divided_attention.py`` and ``csrc/`` (K1, K2): the divided
attention's least time for the traced clips over the device time of the
kernels named as attention in ``metrics/_shared.py``, in percent."""

from hhbench.metrics._shared import attn_roofline


def read(run):
    return attn_roofline(run)
