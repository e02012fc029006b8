"""``models/narrator.py::KimiNarratorModel.narrate`` (the whole narrated
batch): clips x ``counts.kimivl.flops_per_clip`` over the window (run
without the profiler), in percent of the card's dense peak in the model's
type."""

from hhbench.counts.kimivl import flops_per_clip
from hhbench.metrics._shared import mfu


def read(run):
    return mfu(run, flops_per_clip(run.cfg))
