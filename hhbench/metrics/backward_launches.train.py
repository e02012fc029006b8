"""Autograd (the step's backward, on autograd's device thread on a card):
kernel-launch calls inside the step's ``hh.step.backward`` ranges, a step."""

from hhbench.metrics._program import launches_per_step


def read(run):
    return launches_per_step(run, "hh.step.backward")
