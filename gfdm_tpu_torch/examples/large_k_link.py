#!/usr/bin/env python3
"""Large-K GFDM link on the factored kernels.

At K >= 256 a dense operator is out of reach (the Tx operator alone would
be ~50 MB at K=256, ~830 MB at K=1024), so the link runs the factored
kernel pair: ``tx_frame_factored`` (per-subcarrier M-FFT, overlap-add,
Cooley-Tukey IFFT) into ``rx_receiver_factored(estimator="fast")`` (the
adjoint structure, on the factorized torch-op channel estimate). The port
of examples/large_k_link.py, on the card (``--device cpu``: on the CPU, the
kernels' plain versions).

This example runs the K=256 link end to end on a noisy channel and checks
payload recovery. The reference's kernels are size-independent O(N log N)
C++ loops (modulator_kernel_cc.cc:98-141).
"""
import numpy as np
import torch

from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.device import resolve_device
from gfdm_tpu_torch.kernels.fused import rx_receiver_factored, tx_frame_factored
from gfdm_tpu_torch.ops import planar as pl
from gfdm_tpu_torch.ops.operators import demap_indices
from gfdm_tpu_torch.ref import utils


def main(batch=4, device=None):
    dev = resolve_device(device, "large_k_link")
    cfg = GfdmConfig(subcarriers=256, active_subcarriers=200, timeslots=9,
                     cp_len=64, cs_len=32)
    print(f"K={cfg.subcarriers} M={cfg.timeslots} frame_len={cfg.frame_len} "
          f"n_data={cfg.n_data_symbols}")
    d = np.stack(
        [utils.random_qpsk(cfg.n_data_symbols, seed=60 + i) for i in range(batch)]
    ).astype(np.complex64)
    data = torch.from_numpy(pl.to_planar(d).astype(np.float32)).to(dev)

    bursts = tx_frame_factored(cfg, data)
    # light AWGN channel
    rng = np.random.default_rng(0)
    noise = 0.001 * rng.standard_normal(tuple(bursts.shape)).astype(np.float32)
    noisy = bursts + torch.from_numpy(noise).to(dev)
    _chan, sym = rx_receiver_factored(cfg, noisy.contiguous(), ic_iterations=2,
                                      estimator="fast")
    got = sym[..., torch.from_numpy(demap_indices(cfg)).to(dev)].cpu().numpy()
    got_c = got[:, 0] + 1j * got[:, 1]
    evm = utils.evm(utils.qpsk_hard_map(got_c), d)
    sym_err = np.mean(np.sign(got_c.real) != np.sign(d.real)) + np.mean(
        np.sign(got_c.imag) != np.sign(d.imag)
    )
    print(f"decision EVM vs payload: {evm:.2e}   symbol errors: {sym_err:.0%}")
    if not evm < 1e-5:
        raise RuntimeError(f"large-K link decision EVM {evm:.2e} >= 1e-5")
    return {"evm": float(evm), "symbol_error_share": float(sym_err)}


if __name__ == "__main__":
    from gfdm_tpu_torch.examples import parse_device

    main(device=parse_device(__doc__))
