"""Golden reference model: the NumPy/float64 modules the port's operators need.

Copies of the matching ``gfdm_tpu.ref`` modules (framework-free). They are
copied rather than imported because importing ``gfdm_tpu`` imports JAX.
"""
from . import (  # noqa: F401
    channel_estimation,
    correlation,
    cyclic_prefix,
    demodulation,
    filters,
    legacy,
    mapping,
    modulation,
    preamble,
    symbolmapping,
    synchronization,
    utils,
    validation,
    zadoff_chu,
)
