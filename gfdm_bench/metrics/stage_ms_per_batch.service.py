"""Host milliseconds a served batch in the program's ``gfdm.service.stage``
span (the pinned buffer and the NumPy copy of the batch into it), over the
traced window."""
from gfdm_bench.metrics._spans import span_ms_per


def read(run):
    return span_ms_per(run, "gfdm.service.stage", "batches")
