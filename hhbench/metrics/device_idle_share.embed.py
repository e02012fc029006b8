"""The device: percent of the traced window in which no device operation
ran (kernels, copies and sets, merged)."""

from hhbench.metrics._shared import idle_share


def read(run):
    return idle_share(run)
