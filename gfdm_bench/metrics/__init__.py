"""Per-layer metric readers, one file a metric, found by the metric's name.

Each file has ``read(run) -> float | None``: the metric from the run's
traced window (``run.trace``), its measured window (``run.window``) and the
least-work counts (``counts/``); None where there is nothing to read.
"""
