"""Host milliseconds a served batch in the program's ``gfdm.service.stage.wait``
span (the loop's thread waiting for the staging thread's copy of the batch),
over the traced window."""
from gfdm_bench.metrics._spans import span_ms_per


def read(run):
    return span_ms_per(run, "gfdm.service.stage.wait", "batches")
