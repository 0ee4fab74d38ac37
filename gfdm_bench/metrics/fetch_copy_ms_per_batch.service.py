"""Host milliseconds a served batch in the program's
``gfdm.service.fetch.copy`` span (the outputs' copies into pageable host
memory, after the wait), over the traced window."""
from gfdm_bench.metrics._spans import span_ms_per


def read(run):
    return span_ms_per(run, "gfdm.service.fetch.copy", "batches")
