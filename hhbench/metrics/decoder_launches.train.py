"""``models/obj_decoder.py`` (the decoder and its projections):
kernel-launch calls inside the step's ``hh.step.decoder`` ranges, a step."""

from hhbench.metrics._program import launches_per_step


def read(run):
    return launches_per_step(run, "hh.step.decoder")
