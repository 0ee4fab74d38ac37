"""Host milliseconds a served batch in the program's ``gfdm.service.step``
span (enqueueing the step: detection, extraction, CFO, receiver and, with
``fec``, the decoder), over the traced window."""
from gfdm_bench.metrics._spans import span_ms_per


def read(run):
    return span_ms_per(run, "gfdm.service.step", "batches")
