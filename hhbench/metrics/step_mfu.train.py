"""``train/step.py``: the whole step's share of the card's dense peak in
the tower's type, over the window (run without the profiler): clips x
``counts.flops.train_step_flops_per_clip`` / window / peak, in percent."""

from hhbench.counts.flops import train_step_flops_per_clip
from hhbench.metrics._shared import mfu


def read(run):
    return mfu(run, train_step_flops_per_clip(run.cfg, run.cfg["train"]["rephrase_factor"]))
