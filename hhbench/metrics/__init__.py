"""Per-layer metric readers, one file a metric, loaded by path
(``harness.load_metric``): each defines ``read(run) -> float | None`` and
returns None where it finds nothing to read."""
