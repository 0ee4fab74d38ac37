"""The reference's example scripts on the port, run as modules:

    python -m gfdm_tpu_torch.examples.loopback_simulation [--device cpu]
    python -m gfdm_tpu_torch.examples.ota_style_link [--device cpu]
    python -m gfdm_tpu_torch.examples.ber_sweep [--device cpu]
    python -m gfdm_tpu_torch.examples.coded_link [--device cpu]
    python -m gfdm_tpu_torch.examples.spectrum_study [--device cpu]
    python -m gfdm_tpu_torch.examples.cdd_two_antenna [--device cpu]
    python -m gfdm_tpu_torch.examples.coded_service [--device cpu]
    python -m gfdm_tpu_torch.examples.full_duplex_udp [--device cpu]
    python -m gfdm_tpu_torch.examples.large_k_link [--device cpu]
    python -m gfdm_tpu_torch.examples.stream_receiver [--device cpu]
    python -m gfdm_tpu_torch.examples.streaming_service [--device cpu]
    python -m gfdm_tpu_torch.examples.multichip_sharding [--device cpu]

Each keeps its counterpart's defaults and printout (examples/*.py of the
JAX package) and runs on the card unless given ``--device cpu``; each
``main`` takes ``device`` and returns the figures it prints.
"""
from __future__ import annotations

import argparse


def parse_device(description: str, argv: list[str] | None = None) -> str:
    """The ``--device {cuda,cpu}`` option of an example's command line
    (default ``cuda``); without a card and without ``--device cpu`` it exits
    with a usage error naming ``--device cpu``."""
    p = argparse.ArgumentParser(description=description.strip().split("\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device (default: cuda; cpu runs the example on the CPU)")
    args = p.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            p.error("no CUDA device; pass --device cpu to run on the CPU")
    return args.device
