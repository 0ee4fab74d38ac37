"""Transmitter chain composite on complex tensors (the port of
``gfdm_tpu.runtime.transmitter``).

Mirrors the production Tx entry point transmitter_cc (resource mapper ->
modulator -> per-shift cyclic prefixer + preamble insertion,
gr-gfdm/lib/transmitter_cc_impl.cc:130-195) plus the short_burst_shaper's
zero padding and complex scaling (gr-gfdm/lib/short_burst_shaper_impl.cc:161-182).
"""
from __future__ import annotations

import torch

from ..config import GfdmConfig
from ..ops import tx as tx_ops
from ..ops._complex import DEFAULT_DTYPE, as_complex

__all__ = ["transmit_bursts", "shape_bursts"]


def transmit_bursts(cfg: GfdmConfig, data, dtype=DEFAULT_DTYPE, device=None):
    """(..., n_data) payload symbols -> (..., n_shifts, frame_len) bursts.

    A NumPy payload goes to ``device``: the card unless the caller passes
    ``device="cpu"`` (without a card and without ``device`` it raises)."""
    return tx_ops.transmit(cfg, data, dtype=dtype, device=device)


def shape_bursts(cfg: GfdmConfig, bursts, scale=1.0, pre: int | None = None,
                 post: int | None = None, dtype=DEFAULT_DTYPE, device=None):
    """Zero-pad bursts to the padded frame length and apply a complex scale.

    Defaults reproduce the canonical padding that rounds the frame to a
    power of two (configurator.py:22-33).
    """
    pre = cfg.pre_padding_len if pre is None else int(pre)
    post = cfg.post_padding_len if post is None else int(post)
    bursts = as_complex(bursts, dtype, device, "shape_bursts")
    scale = torch.as_tensor(scale, device=bursts.device).to(dtype)
    zpre = bursts.new_zeros(bursts.shape[:-1] + (pre,))
    zpost = bursts.new_zeros(bursts.shape[:-1] + (post,))
    return torch.cat([zpre, bursts * scale, zpost], dim=-1)
