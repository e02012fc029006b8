"""``ops/sampling.py`` (the hand-written sampler kernel): percent of the
tokens drawn in the traced batch whose row the kernel drew, the counter
``hh.narrate.sample_kernel_rows`` over ``hh.narrate.tokens``. A program
without that counter (one that samples by a sort) reads nothing."""

from hhbench.metrics._program import table


def read(run):
    t = table(run) or {}
    rows, tokens = t.get("hh.narrate.sample_kernel_rows"), t.get("hh.narrate.tokens")
    if rows is None or tokens is None or not tokens["count"]:
        return None
    return 100.0 * rows["count"] / tokens["count"]
