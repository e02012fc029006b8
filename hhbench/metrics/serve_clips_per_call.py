"""``serve/engine.py``: clips a device call in the window (items /
device_calls of the engine's ``_Stats``), the micro-batching's reach."""


def read(run):
    c = run.counters
    return c["items"] / c["device_calls"] if c.get("device_calls") else None
