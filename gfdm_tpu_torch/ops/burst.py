"""Burst extraction on complex tensors (the port of ``gfdm_tpu.ops.burst``):
fixed-length windows cut from a stream at detected positions, with power
normalization and CFO derotation.

Static-shape reformulation of the tag-driven extract_burst_cc block
(gr-gfdm/lib/extract_burst_cc_impl.cc:117-241): GR's dynamic tag offsets
become index tensors from the detector; the pre-roll ("tag_backoff")
zero-fill at stream start is reproduced by masking out-of-range positions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import GfdmConfig
from ._complex import DEFAULT_DTYPE, as_complex, real_dtype

__all__ = ["extract_bursts", "remove_prefix"]


def extract_bursts(
    cfg: GfdmConfig,
    stream,
    detection,
    burst_len: int | None = None,
    backoff: int | None = None,
    correct_cfo: bool = True,
    dtype=DEFAULT_DTYPE,
    device=None,
):
    """Cut one burst per stream chunk using detector metadata.

    ``detection`` is the dict from :func:`.sync.detect_bursts` (start points
    at the core preamble). With the default backoff == cp_len the returned
    burst is aligned at the start of the full windowed preamble and spans
    the whole frame (preamble + CP + payload + CS).
    """
    burst_len = cfg.frame_len if burst_len is None else int(burst_len)
    backoff = cfg.cp_len if backoff is None else int(backoff)
    stream = as_complex(stream, dtype, device, "extract_bursts")
    dev, T = stream.device, stream.shape[-1]
    rdt = real_dtype(dtype)
    start = torch.as_tensor(detection["start"], device=dev)
    scale = torch.as_tensor(detection["scale"], device=dev)
    # gather window [start - backoff, start - backoff + burst_len)
    offs = torch.arange(burst_len, device=dev)
    idx = start[..., None] + offs - backoff  # (..., burst_len)
    burst = torch.gather(stream, -1, idx.clamp(0, T - 1))
    # zero-fill out-of-range positions (stream start/end), like the
    # reference's prepend-zero handling (extract_burst_cc_impl.cc:184-191)
    valid = (idx >= 0) & (idx < T)
    burst = torch.where(valid, burst, torch.zeros((), dtype=burst.dtype, device=dev))
    burst = burst * scale[..., None].to(rdt)
    if correct_cfo:
        # derotate e^{-j 2 pi cfo n / K} from the window start, the phase
        # rounded as the JAX package's complex64 product rounds it
        cfo = torch.as_tensor(detection["cfo"], device=dev)[..., None].to(rdt)
        two_pi = torch.tensor(-2.0 * np.pi, dtype=rdt, device=dev)
        phase = two_pi * cfo * offs.to(rdt) / cfg.subcarriers
        burst = burst * torch.polar(torch.ones_like(phase), phase)
    return burst


def remove_prefix(frames: torch.Tensor, offset: int, length: int) -> torch.Tensor:
    """(..., T) -> (..., length): tag-driven frame slice analogue.

    Mirror of remove_prefix_cc (gr-gfdm/lib/remove_prefix_cc_impl.cc:84-115):
    copy ``length`` samples starting at ``offset`` within each tagged frame.
    """
    if not 0 <= int(offset) <= int(offset) + int(length) <= frames.shape[-1]:
        raise ValueError(f"remove_prefix: [{offset}, {offset} + {length}) is not within "
                         f"the last dimension of shape {tuple(frames.shape)}")
    return frames[..., int(offset) : int(offset) + int(length)]
