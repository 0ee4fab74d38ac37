"""The device's idle share in the traced window (profiler timeline): 100 x
(1 - busy / window)."""
from gfdm_bench.metrics._idle import idle_share


def read(run):
    return idle_share(run)
