"""Monte-Carlo link evaluation: BER/EVM over SNR, batched on the device.

The port of ``gfdm_tpu.eval.ber``, the replacement of the reference's
multiprocessing BER sweep harness (gr-gfdm/python/pygfdm/testsuite.py:11-80):
each SNR point is one batched end-to-end link - the planar torch-op
``transmit_planar`` -> channel -> AWGN -> ``receive_bursts_planar`` - over
thousands of bursts on ``device`` (default: the card; without one it
raises).

Random draws: the payload bits come from NumPy's generator seeded by
``seed``, as in the JAX package, so a seed sends the same bits in both. The
channel taps and the noise come from a CPU ``torch.Generator`` seeded by
``seed`` where the JAX package draws from ``jax.random``: the numbers differ
from JAX's for the same seed, but not between the card and the CPU (the
draws are made on the CPU and moved). :func:`_sweep_fn`'s point takes the
unit taps and the unit noise as tensors, so a caller can feed it the draws
it also feeds to the JAX composite.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import GfdmConfig
from ..device import as_tensor, device_const, resolve_device
from ..ops.planar_pipeline import prepare, receive_bursts_planar, transmit_planar

__all__ = ["ber_sweep", "qpsk_bits_to_planar", "planar_to_bits"]


def qpsk_bits_to_planar(bits):
    """(..., n_data, 2) bits -> (..., 2, n_data) planar QPSK symbols (NumPy)."""
    symbols = (1.0 - 2.0 * bits.astype(np.float32)) / np.sqrt(2.0)
    return np.moveaxis(symbols, -1, -2)


def planar_to_bits(symbols, device=None):
    """(..., 2, n_data) planar symbols -> (..., n_data, 2) hard bits (bool)."""
    return torch.movedim(as_tensor(symbols, device, "planar_to_bits") < 0.0, -2, -1)


def _unit_normal(source, shape, device) -> torch.Tensor:
    """Standard-normal float32 draws: from ``source`` (a torch.Generator,
    drawn on its device and moved) or ``source`` itself (a tensor)."""
    if isinstance(source, torch.Generator):
        return torch.randn(tuple(shape), generator=source, device=source.device).to(device)
    x = torch.as_tensor(source, device=device)
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"expected unit draws of shape {tuple(shape)}, got {tuple(x.shape)}")
    return x.to(torch.float32)


def _apply_multipath(source, bursts, n_taps: int, decay: float = 1.0):
    """Per-burst random frequency-selective Rayleigh channel (planar).

    Taps are CN(0, p_l) with an exponential power-delay profile
    p_l ~ exp(-decay*l), normalized to unit total power; tap 0 keeps the
    burst causally aligned and ``n_taps <= cp_len`` keeps all ISI inside the
    cyclic prefix. ``source``: a ``torch.Generator`` or the (B, 2, n_taps)
    unit normal draws themselves.
    """
    B, _, L = bursts.shape
    profile = np.exp(-decay * np.arange(n_taps)).astype(np.float32)
    profile /= profile.sum()
    amp = torch.sqrt(torch.from_numpy(profile).to(bursts.device) / 2.0)
    taps = amp[None, None, :] * _unit_normal(source, (B, 2, n_taps), bursts.device)
    # y[t] = sum_l h[l] * x[t-l], complex product in planar form
    y_r = bursts.new_zeros((B, L))
    y_i = bursts.new_zeros((B, L))
    x_r, x_i = bursts[:, 0, :], bursts[:, 1, :]
    for lag in range(n_taps):
        xs_r = torch.nn.functional.pad(x_r, (lag, 0))[:, :L]
        xs_i = torch.nn.functional.pad(x_i, (lag, 0))[:, :L]
        h_r, h_i = taps[:, 0, lag : lag + 1], taps[:, 1, lag : lag + 1]
        y_r = y_r + h_r * xs_r - h_i * xs_i
        y_i = y_i + h_r * xs_i + h_i * xs_r
    return torch.stack([y_r, y_i], dim=-2)


def _apply_cfo(cfg: GfdmConfig, bursts, cfo: float):
    """Constant carrier-frequency offset (fraction of subcarrier spacing)."""
    L = bursts.shape[-1]
    phase = 2.0 * np.pi * cfo * np.arange(L) / cfg.subcarriers
    c = torch.from_numpy(np.cos(phase).astype(np.float32)).to(bursts.device)
    s = torch.from_numpy(np.sin(phase).astype(np.float32)).to(bursts.device)
    r, i = bursts[..., 0, :], bursts[..., 1, :]
    return torch.stack([r * c - i * s, r * s + i * c], dim=-2)


def _add_noise(bursts: torch.Tensor, snr_db, noise: torch.Tensor) -> torch.Tensor:
    """AWGN at the target SNR (planar): noise variance per real component
    from the bursts' mean power, times the unit draws."""
    snr = torch.as_tensor(snr_db, dtype=torch.float32, device=bursts.device)
    power = torch.mean(torch.sum(bursts**2, dim=-2))
    nvar = power / (2.0 * 10.0 ** (snr / 10.0))
    return bursts + torch.sqrt(nvar) * noise


@lru_cache(maxsize=32)
def _sweep_fn(cfg: GfdmConfig, ic_iterations: int, constellation: str,
              equalizer: str, channel: str, n_channel_taps: int, cfo: float):
    """The per-point link: ``one_point(snr_db, batch_bits, noise, taps=None)``
    -> (bit errors, EVM, mean estimated linear SNR) as 0-d tensors.

    ``batch_bits``: (B, n_data, order) in {0, 1} (index = bits, MSB first,
    per ref.symbolmapping.bits_to_symbols); ``noise``: the (B, 2,
    frame_len) unit normal draws; ``taps``: the (B, 2, n_channel_taps) unit
    normal draws of the multipath channel (with channel="multipath"). The
    link runs on the device of ``noise``."""
    from ..ops.rx import constellation_points

    points = constellation_points(constellation)
    order = int(np.log2(points.size))  # bits per symbol

    def consts(device):
        return device_const(("ber.points", constellation), device, lambda: {
            "pr": points.real.astype(np.float32), "pi": points.imag.astype(np.float32),
            "weights": (1 << np.arange(order - 1, -1, -1)).astype(np.int64),
            "shifts": np.arange(order - 1, -1, -1).astype(np.int64)})

    def one_point(snr_db, batch_bits, noise, taps=None):
        dev = noise.device
        c = consts(dev)
        bits = torch.as_tensor(batch_bits, device=dev).to(torch.int64)
        idx = torch.sum(bits * c["weights"], dim=-1)
        data = torch.stack([c["pr"][idx], c["pi"][idx]], dim=-2)  # (B, 2, n_data)
        bursts = transmit_planar(cfg, data)[:, 0, :, :]  # (B, 2, L)
        if channel == "multipath":
            bursts = _apply_multipath(taps, bursts, n_channel_taps)
        if cfo:
            bursts = _apply_cfo(cfg, bursts, cfo)
        out = receive_bursts_planar(
            cfg, _add_noise(bursts, snr_db, noise), ic_iterations=ic_iterations,
            constellation=points, equalizer=equalizer,
        )
        # hard decision back to bit indices (nearest point, first of ties)
        r, i = out["data"][..., 0, :], out["data"][..., 1, :]
        dist = (r[..., None] - c["pr"]) ** 2 + (i[..., None] - c["pi"]) ** 2
        idx_hat = torch.argmin(dist, dim=-1)
        rx_bits = (idx_hat[..., None] >> c["shifts"]) & 1
        errors = torch.sum(rx_bits != bits)
        err = torch.sum((out["data"] - data) ** 2)
        ref = torch.sum(data**2)
        return errors, torch.sqrt(err / ref), torch.mean(out["snr_lin"])

    return one_point


def ber_sweep(
    cfg: GfdmConfig,
    snrs_db,
    bursts_per_point: int = 1024,
    ic_iterations: int = 2,
    seed: int = 0,
    constellation: str = "qpsk",
    equalizer: str = "zf",
    channel: str = "awgn",
    n_channel_taps: int = 8,
    cfo: float = 0.0,
    device=None,
):
    """BER + EVM + estimated-SNR curve over the given SNR points.

    ``constellation``: 'qpsk', 'qam16' or 'qam64' (Gray, per the golden model).
    ``channel``: 'awgn' (flat) or 'multipath' (per-burst Rayleigh taps with an
    exponential power-delay profile, ``n_channel_taps`` long - keep it at or
    below cp_len so ISI stays inside the prefix). ``cfo`` adds a residual
    carrier-frequency offset in subcarrier spacings (uncorrected by this
    receiver path - models post-sync residue). The link runs on ``device``
    (default: the card; without one it raises); the taps and noise come
    from a CPU generator seeded by ``seed`` (module docstring).
    Returns a dict of numpy arrays keyed by 'snr_db', 'ber', 'evm',
    'snr_est_db'.
    """
    if channel not in ("awgn", "multipath"):
        raise ValueError(f"unknown channel model {channel!r}")
    dev = resolve_device(device, "ber_sweep")
    prepare(cfg, device=dev)
    fn = _sweep_fn(cfg, int(ic_iterations), constellation, equalizer,
                   str(channel), int(n_channel_taps), float(cfo))
    from ..ops.rx import constellation_points

    order = int(np.log2(constellation_points(constellation).size))
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(int(seed))
    B = bursts_per_point

    bers, evms, snr_ests = [], [], []
    n_bits = B * cfg.n_data_symbols * order
    for snr_db in np.asarray(snrs_db, dtype=np.float32):
        bits = rng.integers(0, 2, (B, cfg.n_data_symbols, order))
        taps = (_unit_normal(gen, (B, 2, n_channel_taps), dev)
                if channel == "multipath" else None)
        noise = _unit_normal(gen, (B, 2, cfg.frame_len), dev)
        errors, evm, snr_est = fn(float(snr_db), bits, noise, taps)
        bers.append(float(errors) / n_bits)
        evms.append(float(evm))
        snr_ests.append(10.0 * np.log10(max(float(snr_est), 1e-12)))
    return {
        "snr_db": np.asarray(snrs_db, dtype=np.float64),
        "ber": np.asarray(bers),
        "evm": np.asarray(evms),
        "snr_est_db": np.asarray(snr_ests),
    }
