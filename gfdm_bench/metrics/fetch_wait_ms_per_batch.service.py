"""Host milliseconds a served batch in the program's
``gfdm.service.fetch.wait`` span (the wait on an event recorded on the
stream at the fetch's start: every batch enqueued before it), over the
traced window."""
from gfdm_bench.metrics._spans import span_ms_per


def read(run):
    return span_ms_per(run, "gfdm.service.fetch.wait", "batches")
