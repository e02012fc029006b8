"""``train/evaluate.py::EvalModel`` and ``models/``: the embedding
forward's share of the card's dense peak in the tower's type, over the
window (run without the profiler): clips x (visual tower + decoder FLOPs a
clip, ``counts.flops.embed_flops_per_clip``) / window / peak, in percent."""

from hhbench.counts.flops import embed_flops_per_clip
from hhbench.metrics._shared import mfu


def read(run):
    return mfu(run, embed_flops_per_clip(run.cfg))
