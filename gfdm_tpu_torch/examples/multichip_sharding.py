#!/usr/bin/env python3
"""Multi-chip sharded receive demo on a virtual mesh of one device.

Shards bursts over 'dp' and the stream sample axis over 'sp' with the halo
exchange, on eight copies of the card (``--device cpu``: of the CPU): the
port of examples/multichip_sharding.py, through
``gfdm_tpu_torch.entry.dryrun_multichip``.
"""
from gfdm_tpu_torch.entry import dryrun_multichip


def main(device=None):
    return dryrun_multichip(8, device=device)


if __name__ == "__main__":
    from gfdm_tpu_torch.examples import parse_device

    main(device=parse_device(__doc__))
