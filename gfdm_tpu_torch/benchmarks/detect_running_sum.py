"""Why csrc/detect.cu never subtracts a term of a window sum, on the CPU.

The detection kernels give each thread R = 8 consecutive positions. A
running sum would take each group's first p and 2K energy e directly and
slide the next R - 1 (the entering term added, the leaving one subtracted).
After a 60 dB power step that keeps the rounding error of the louder past.
This script computes ac so in NumPy float32 on the chunks of
``entry._dynamic_range_chunks`` (seed 11, the canonical config) and prints
its largest excess over the limits tests/test_torch_gpu.py holds the kernels' traces
to against the plain version (atol 3e-5, rtol 3e-3; <= 1 passes). The
kernels' own schedule meets the limits on the same chunks
(tests/test_torch_detect_tiles.py).

    python -m gfdm_tpu_torch.benchmarks.detect_running_sum
"""
from __future__ import annotations

import numpy as np
import torch

from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import _dynamic_range_chunks
from gfdm_tpu_torch.kernels import detect

R, CHUNK_LEN = 8, 2048
ATOL, RTOL = 3e-5, 3e-3
F32 = np.float32


def running_sum_ac(cfg: GfdmConfig, x: np.ndarray) -> np.ndarray:
    """(B, n_ac) real part of ac from running sums over groups of R."""
    K = cfg.subcarriers
    n_ac = x.shape[-1] - 2 * K
    sr, si = x[:, 0], x[:, 1]
    energy = sr * sr + si * si
    qr = sr[:, :-K] * sr[:, K:] + si[:, :-K] * si[:, K:]
    qi = sr[:, :-K] * si[:, K:] - si[:, :-K] * sr[:, K:]
    e, pr, pi = (np.zeros((x.shape[0], n_ac), F32) for _ in range(3))
    for t in range(n_ac):
        if t % R == 0:
            e[:, t] = energy[:, t : t + 2 * K].sum(axis=1, dtype=F32)
            pr[:, t] = qr[:, t : t + K].sum(axis=1, dtype=F32)
            pi[:, t] = qi[:, t : t + K].sum(axis=1, dtype=F32)
        else:
            e[:, t] = (e[:, t - 1] - energy[:, t - 1]) + energy[:, t - 1 + 2 * K]
            pr[:, t] = (pr[:, t - 1] - qr[:, t - 1]) + qr[:, t - 1 + K]
            pi[:, t] = (pi[:, t - 1] - qi[:, t - 1]) + qi[:, t - 1 + K]
    return pr * (F32(2) / np.maximum(e, F32(1e-30)))


def main() -> None:
    torch.set_num_threads(1)
    cfg = GfdmConfig()
    x = _dynamic_range_chunks(cfg, CHUNK_LEN, np.random.default_rng(11))
    ref = detect._detect_front_plain(cfg, torch.from_numpy(x), CHUNK_LEN)[1][:, 0].numpy()
    acr = running_sum_ac(cfg, x)
    excess = (np.abs(acr - ref) - RTOL * np.abs(ref)).max() / ATOL
    print(f"running sums over groups of {R}: ac's largest excess over the limits {excess:.2f} "
          f"(B={x.shape[0]}, T={x.shape[-1]}, K={cfg.subcarriers})")


if __name__ == "__main__":
    main()
