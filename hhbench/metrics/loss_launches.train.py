"""``losses/`` and ``ops/lap.py`` (EgoNCE, the box matchings and losses,
the word loss): kernel-launch calls inside the step's ``hh.step.losses``
ranges, a step."""

from hhbench.metrics._program import launches_per_step


def read(run):
    return launches_per_step(run, "hh.step.losses")
