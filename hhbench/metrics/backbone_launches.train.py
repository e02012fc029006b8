"""``models/lavila.py`` (the frozen towers' forward): kernel-launch calls
inside the step's ``hh.step.backbone`` ranges, a step."""

from hhbench.metrics._program import launches_per_step


def read(run):
    return launches_per_step(run, "hh.step.backbone")
