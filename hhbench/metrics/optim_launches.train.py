"""``train/step.py`` (gradient averaging, the global norm, clip, AdamW):
kernel-launch calls inside the step's ``hh.step.optim`` ranges, a step."""

from hhbench.metrics._program import launches_per_step


def read(run):
    return launches_per_step(run, "hh.step.optim")
