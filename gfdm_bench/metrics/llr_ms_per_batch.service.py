"""Host milliseconds a served batch in the program's ``gfdm.fec.llr`` span
(enqueueing the decoder's max-log LLRs and the deinterleave, inside
``gfdm.service.decode``), over the traced window; None for a program
without that span."""
from gfdm_bench.metrics._spans import span_ms_per


def read(run):
    return span_ms_per(run, "gfdm.fec.llr", "batches")
