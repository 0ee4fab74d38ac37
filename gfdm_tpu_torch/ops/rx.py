"""Receiver helpers shared by the planar path and the service.

Of ``gfdm_tpu.ops.rx`` (the complex-dtype receiver, ROADMAP.md Queue 1
item 8) only the named-constellation lookup is ported so far: the streaming
service takes its constellation by name.
"""
from __future__ import annotations

import numpy as np

from .planar_pipeline import qpsk_constellation

__all__ = ["constellation_points"]


def constellation_points(name: str) -> np.ndarray:
    """Named constellation -> complex points ('qpsk' | 'qam16' | 'qam64').

    The points come from the golden model (ref.symbolmapping) so decisions
    agree across the planar path, the kernels and the NumPy model.
    """
    if name == "qpsk":
        return qpsk_constellation
    if name in ("qam16", "qam64"):
        from ..ref.symbolmapping import constellation

        return constellation({"qam16": 4, "qam64": 6}[name])
    raise ValueError(
        f"unknown constellation {name!r} (use 'qpsk', 'qam16' or 'qam64')"
    )
