"""``train/step.py`` (the host's launch path): device kernels in the
trace over the steps traced."""


def read(run):
    tr = run.trace_data
    if tr is None or not run.traced_steps:
        return None
    n = len(tr.kernels())
    return n / run.traced_steps if n else None
