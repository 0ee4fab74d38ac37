"""The program's span seconds over the traced window, shared by the
``*_ms_per_batch.service`` and ``*_ms_per_step.link`` readers.

The port's ``gfdm_tpu_torch.utils.profiling.span`` sums, by name, the host
seconds of every span that runs while a ``torch.profiler`` records
(``profiled_spans()``); the traced window is the only stretch of a run
under the profiler, so those sums are the window's. A program without
``profiled_spans``, or a window in which the span never ran, reads None.
"""
from __future__ import annotations


def span_ms_per(run, name: str, count: str) -> float | None:
    """Milliseconds of span ``name`` in the traced window over the window's
    ``count`` (``batches`` or ``steps``)."""
    t = run.trace
    if not t or not t.get(count):
        return None
    try:
        from gfdm_tpu_torch.utils.profiling import profiled_spans
    except ImportError:
        return None
    seconds = profiled_spans().get(name)
    return None if seconds is None else 1e3 * seconds / t[count]
