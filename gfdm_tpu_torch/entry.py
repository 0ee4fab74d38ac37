"""Main-path entry points: the burst link and the service's input stream.

``entry`` is the port's counterpart of ``__graft_entry__.entry`` at the
repository root: its step is the one-kernel link ``link_single_fused`` with
the matmul IC, the path the JAX package's ``bench.py`` times on its
accelerator. ``service_stream`` is the counterpart of
``bench._service_stream``: the burst-bearing chunk stream the streaming
receive service is measured on. ``large_k_config`` is the configuration of
``benchmarks/largek_crossover.py``, the large-K factored link's.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import GfdmConfig
from .kernels.fused import link_single_fused
from .ops.planar_pipeline import prepare, transmit_planar

__all__ = ["entry", "large_k_config", "planar_payload", "service_stream"]


def planar_payload(cfg: GfdmConfig, batch: int, seed: int = 0) -> np.ndarray:
    """(batch, 2, n_data) float32 planar QPSK payload from a numpy seed."""
    rng = np.random.default_rng(seed)
    qpsk = (rng.integers(0, 2, (batch, 2, cfg.n_data_symbols)) * 2 - 1) / np.sqrt(2.0)
    return qpsk.astype(np.float32)


def large_k_config(K: int) -> GfdmConfig:
    """The large-K crossover configuration at K subcarriers: M = 9, the
    canonical 52/64 active ratio, cp = K/4, cs = K/8 (K = 256, 512, 1024
    in the crossover study)."""
    return GfdmConfig(
        subcarriers=K,
        active_subcarriers=int(K * 0.78125),
        timeslots=9,
        cp_len=K // 4,
        cs_len=K // 8,
    )


def entry(device):
    """(fn, example_args): the forward step of the flagship link on ``device``.

    payload symbols -> Tx (map, modulate, CP+window, preamble) -> receiver
    (channel estimation, SNR/CNR, ZF, 2 IC iterations, demap) -> EVM.
    ``fn(data)`` returns (data_hat, snr_lin, evm). On a CUDA device the step
    runs the CUDA link kernel; on the CPU, its plain torch version.
    """
    device = torch.device(device)
    cfg = GfdmConfig()
    prepare(cfg, device=device)

    def step(data):
        return link_single_fused(cfg, data, ic_iterations=2, ic_mode="matmul")

    data = torch.from_numpy(planar_payload(cfg, batch=64, seed=0)).to(device)
    return step, (data,)


def service_stream(cfg: GfdmConfig, n_chunks: int, chunk_len: int, snr_db: float,
                   impaired: bool, rng: np.random.Generator):
    """Synthesize a burst-bearing chunk stream for the receive service.

    Returns ``(chunks, counts, payload)``: (n_chunks, 2, chunk_len + halo)
    float32 halo-extended chunks, the bursts placed in each chunk, and the
    (n_bursts, 2, n_data) float32 QPSK payload of the bursts in placement
    order. Makes the same ``rng`` calls in the same order as the JAX
    package's ``bench._service_stream``, so a seed gives the same counts,
    offsets, taps, CFOs and noise there and here.

    Offsets are drawn from the owned range [0, chunk_len - cp_len): the
    service owns a burst whose xcorr peak (cp_len into the burst) lies
    before chunk_len. AWGN at ``snr_db`` per sample over the bursts' power.
    ``impaired`` adds per-burst 8-tap Rayleigh multipath, residual CFO up to
    +-0.2 subcarriers and mixed density: ~25% empty chunks and ~25%
    two-burst chunks (the first in the left third, the second in the right
    half), for a receiver with max_bursts_per_chunk=2.
    """
    halo = cfg.frame_len + cfg.cp_len
    ext = chunk_len + halo
    max_off = chunk_len - cfg.cp_len
    counts = (
        rng.choice([0, 1, 2], n_chunks, p=[0.25, 0.5, 0.25])
        if impaired
        else np.ones(n_chunks, np.int64)
    )
    n_bursts = int(counts.sum())
    qpsk = (rng.integers(0, 2, (n_bursts, 2, cfg.n_data_symbols)) * 2 - 1) / np.sqrt(2.0)
    payload = qpsk.astype(np.float32)
    bursts = transmit_planar(cfg, torch.from_numpy(payload))[:, 0].numpy()
    bc = bursts[:, 0] + 1j * bursts[:, 1]
    if impaired:
        taps = (
            rng.standard_normal((n_bursts, 8)) + 1j * rng.standard_normal((n_bursts, 8))
        ) * (0.5 ** np.arange(8)) / np.sqrt(2.0)
        taps /= np.linalg.norm(taps, axis=1, keepdims=True)
        L = bc.shape[1]
        H = np.fft.fft(taps, L + 8, axis=1)
        bc = np.fft.ifft(np.fft.fft(bc, L + 8, axis=1) * H, axis=1)[:, : L + 7]
        cfo = rng.uniform(-0.2, 0.2, n_bursts)
        bc *= np.exp(
            2j * np.pi * cfo[:, None] * np.arange(bc.shape[1]) / cfg.subcarriers
        )
    blen = bc.shape[1]
    sig_power = float(np.mean(np.abs(bc) ** 2))  # per-sample signal power
    noise_amp = np.sqrt(sig_power * 10 ** (-snr_db / 10) / 2)
    stream = noise_amp * rng.standard_normal((n_chunks, 2, ext))
    bi = 0
    for i in range(n_chunks):
        if counts[i] == 1:
            pos = [rng.integers(0, max_off)]
        elif counts[i] == 2:
            pos = [rng.integers(0, chunk_len // 3 - cfg.cp_len),
                   rng.integers(chunk_len // 2 + cfg.frame_len // 2, max_off)]
        else:
            pos = []
        for p in pos:
            stream[i, 0, p : p + blen] += bc[bi].real
            stream[i, 1, p : p + blen] += bc[bi].imag
            bi += 1
    return stream.astype(np.float32), counts, payload
