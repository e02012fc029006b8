"""``data/`` (``PrefetchLoader``'s decode threads): host milliseconds a
clip read (``hh.data.item``, the program's counter), in the traced
stretch."""

from hhbench.metrics._program import table


def read(run):
    e = (table(run) or {}).get("hh.data.item")
    if not e or not e["count"]:
        return None
    return 1e3 * e["host_s"] / e["count"]
