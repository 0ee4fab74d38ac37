"""Host milliseconds a link step in the program's ``gfdm.link.step`` span
(the whole step's enqueue, on the host), over the traced window."""
from gfdm_bench.metrics._spans import span_ms_per


def read(run):
    return span_ms_per(run, "gfdm.link.step", "steps")
