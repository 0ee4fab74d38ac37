"""The device's idle share of a traced window, shared by the
``device_idle_share.*`` readers."""
from __future__ import annotations


def idle_share(run) -> float | None:
    """100 x (1 - busy / window): the traced window less the union of its
    device kernels, copies and memsets (tracing.summarize)."""
    t = run.trace
    if not t or t.get("window_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
