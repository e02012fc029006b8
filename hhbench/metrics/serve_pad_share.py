"""``serve/engine.py``: padded rows over all rows the engine's device calls
ran in the window, in percent, from the engine's ``_Stats`` (padded_items
/ (items + padded_items))."""


def read(run):
    c = run.counters
    rows = c.get("items", 0) + c.get("padded_items", 0)
    return 100.0 * c["padded_items"] / rows if rows else None
