"""Mesh sharding, halo exchange and distributed metrics on torch devices.

The multi-process serve lives in :mod:`gfdm_tpu_torch.parallel.multihost`
(run as ``python -m gfdm_tpu_torch.parallel.multihost``).
"""
from .mesh import (  # noqa: F401
    Mesh,
    detect_bursts_sharded,
    dp_map,
    halo_exchange_right,
    make_mesh,
    psum_metrics,
    shard_bursts,
)
