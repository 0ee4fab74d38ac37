"""Host milliseconds a served batch in the program's ``gfdm.service.decode``
span (enqueueing the soft decoder: LLRs, deinterleave, the Viterbi's ACS and
traceback), over the traced window."""
from gfdm_bench.metrics._spans import span_ms_per


def read(run):
    return span_ms_per(run, "gfdm.service.decode", "batches")
