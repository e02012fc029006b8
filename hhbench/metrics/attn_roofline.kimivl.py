"""``ops/divided_attention.py`` and ``csrc/`` (K1, K2) in the 336 px tower
under Kimi-VL's language model: the tower's divided attention over its
least time, as ``attn_roofline.narrate`` reads it for the same tower
(``counts/attention.py`` on the configuration's ``visual`` group, over the
device time of the tower's own attention kernels), in percent. None
without such kernels (a CPU run)."""

from hhbench.harness import load_metric


def read(run):
    return load_metric("attn_roofline.narrate").read(run)
