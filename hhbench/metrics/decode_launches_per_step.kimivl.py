"""``models/kimi_lm.py`` (the decode steps): launch calls inside the
``hh.narrate.decode`` ranges, over the decode steps traced, as
``decode_launches_per_step.narrate`` counts them: kernel launches, and on
the card the CUDA graph launches that replay a step. About 1 where the
experts' routing stays inside the step's graph."""

from hhbench.harness import load_metric


def read(run):
    return load_metric("decode_launches_per_step.narrate").read(run)
