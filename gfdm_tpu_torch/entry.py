"""Main-path entry point: the end-to-end GFDM burst link on one device.

The port's counterpart of ``__graft_entry__.entry`` at the repository root.
Its step is the one-kernel link ``link_single_fused`` with the matmul IC,
the path the JAX package's ``bench.py`` times on its accelerator.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import GfdmConfig
from .kernels.fused import link_single_fused
from .ops.planar_pipeline import prepare

__all__ = ["entry", "planar_payload"]


def planar_payload(cfg: GfdmConfig, batch: int, seed: int = 0) -> np.ndarray:
    """(batch, 2, n_data) float32 planar QPSK payload from a numpy seed."""
    rng = np.random.default_rng(seed)
    qpsk = (rng.integers(0, 2, (batch, 2, cfg.n_data_symbols)) * 2 - 1) / np.sqrt(2.0)
    return qpsk.astype(np.float32)


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
