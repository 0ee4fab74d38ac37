"""Channel simulation for tests, benchmarks and link demos (the port of
``gfdm_tpu.runtime.channel``).

The reference simulates channels in QA with np.convolve + synthetic AWGN;
this is the batched torch equivalent: static multipath (causal FIR), AWGN at
a target SNR, CFO, and a burst placed inside a longer noise floor. Random
draws take an explicit ``torch.Generator`` where the JAX package takes a
``jax.random`` key; :func:`awgn` and :func:`place_in_stream` also take the
unit complex noise itself (a tensor whose real and imaginary parts are
standard normal), so a caller can feed the same noise to both packages.
"""
from __future__ import annotations

import math

import torch

__all__ = ["awgn", "apply_cfo", "multipath", "place_in_stream"]


def multipath(signal: torch.Tensor, taps) -> torch.Tensor:
    """Causal FIR channel along the last axis (same length as input)."""
    taps = torch.as_tensor(taps, device=signal.device).to(signal.dtype)
    n = taps.shape[-1]
    padded = torch.cat([signal.new_zeros(signal.shape[:-1] + (n - 1,)), signal], dim=-1)
    # correlation with reversed taps == convolution
    windows = torch.stack([padded[..., i : i + signal.shape[-1]] for i in range(n)], dim=-1)
    return torch.sum(windows * taps.flip(-1), dim=-1)


def _unit_noise(source, shape, device) -> torch.Tensor:
    """Complex noise with standard-normal real and imaginary parts: drawn
    from ``source`` (a torch.Generator, on its own device, then moved) or
    ``source`` itself (a tensor of that shape)."""
    if isinstance(source, torch.Generator):
        draw = [torch.randn(tuple(shape), generator=source, device=source.device)
                for _ in range(2)]
        return torch.complex(*draw).to(device)
    noise = torch.as_tensor(source, device=device)
    if tuple(noise.shape) != tuple(shape) or not noise.is_complex():
        raise ValueError(f"noise must be a complex tensor of shape {tuple(shape)}, got "
                         f"{noise.dtype} {tuple(noise.shape)}")
    return noise


def awgn(source, signal: torch.Tensor, snr_db: float, measure=None) -> torch.Tensor:
    """Add complex AWGN at the given SNR (energy measured over ``measure``).

    ``source``: a ``torch.Generator`` or the unit complex noise itself."""
    ref = signal if measure is None else measure
    avg_energy = torch.mean(ref.abs() ** 2)
    nvar = avg_energy / (2.0 * 10.0 ** (snr_db / 10.0))
    noise = torch.sqrt(nvar) * _unit_noise(source, signal.shape, signal.device)
    return signal + noise.to(signal.dtype)


def apply_cfo(signal: torch.Tensor, cfo, fft_len) -> torch.Tensor:
    """Multiply by e^{j 2 pi cfo n / fft_len} along the last axis."""
    n = torch.arange(signal.shape[-1], dtype=torch.float32, device=signal.device)
    if isinstance(cfo, torch.Tensor):
        w = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=signal.device) * cfo
    else:  # a number: 2 pi cfo rounded once, as JAX's weak-typed scalar is
        w = torch.tensor(2.0 * math.pi * cfo, dtype=torch.float32, device=signal.device)
    phase = w * n / fft_len
    return signal * torch.polar(torch.ones_like(phase), phase).to(signal.dtype)


def place_in_stream(source, bursts: torch.Tensor, chunk_len: int, offset: int,
                    noise_floor: float = 0.0) -> torch.Tensor:
    """Embed each burst at ``offset`` inside a longer noise-floor chunk.

    ``source``: a ``torch.Generator`` or the unit complex noise itself
    (unused when ``noise_floor`` is 0)."""
    shape = bursts.shape[:-1] + (int(chunk_len),)
    if noise_floor > 0.0:
        stream = (noise_floor * _unit_noise(source, shape, bursts.device)).to(bursts.dtype)
    else:
        stream = bursts.new_zeros(shape)
    stream[..., offset : offset + bursts.shape[-1]] += bursts
    return stream
