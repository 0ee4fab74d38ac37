#!/usr/bin/env python3
"""Cyclic-delay-diversity (CDD) two-antenna transmit demo.

The reference's transmitter_cc emits one output stream per cyclic shift for
multi-antenna Tx (gr-gfdm/lib/transmitter_cc_impl.cc:165-177); each port
carries the SAME modulated frame cyclically shifted, with a per-shift
preamble. At the receiver the superposition of the antenna paths looks like
one effective multipath channel that the ordinary preamble estimator absorbs
(reference QA: qa_python_bindings.py:532-638). The port of
examples/cdd_two_antenna.py: the complex-dtype chain on the card
(``--device cpu``: on the CPU); the noise from a CPU torch.Generator.

This demo transmits a burst batch over both CDD ports, sums the ports
through independent per-antenna multipath channels + AWGN, and recovers the
payload with the standard single-antenna receiver.
"""
import numpy as np
import torch

from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.device import resolve_device
from gfdm_tpu_torch.entry import CDD_TAPS
from gfdm_tpu_torch.ops.tx import transmit as transmit_bursts
from gfdm_tpu_torch.ref import utils
from gfdm_tpu_torch.runtime import channel as chan
from gfdm_tpu_torch.runtime.receiver import receive_bursts

SYMBOL_ERROR_FLOOR = 1e-3  # the share of symbols in error that fails the check


def main(n_bursts=8, snr_db=28.0, device=None):
    dev = resolve_device(device, "cdd_two_antenna")
    cfg = GfdmConfig(cyclic_shifts=(0, 2))
    print(f"config: M={cfg.timeslots} K={cfg.subcarriers} "
          f"cyclic_shifts={cfg.cyclic_shifts} (one Tx port per shift)")

    data = np.stack(
        [utils.random_qpsk(cfg.n_data_symbols, seed=100 + i) for i in range(n_bursts)]
    )
    bursts = transmit_bursts(cfg, data.astype(np.complex64), device=dev)
    print(f"tx ports: {bursts.shape[1]}, burst len {bursts.shape[-1]}")

    # independent per-antenna multipath, then superposition at the receiver
    rx = chan.multipath(bursts[:, 0], CDD_TAPS[0]) + chan.multipath(bursts[:, 1], CDD_TAPS[1])
    rx = chan.awgn(torch.Generator().manual_seed(3), rx, snr_db)

    out = receive_bursts(cfg, rx, ic_iterations=4)
    d_hat = out["data"].cpu().numpy()
    hard = utils.qpsk_hard_map(d_hat)
    sym_errors = int(np.sum(np.abs(hard - data) > 0.1))
    evm = float(np.sqrt(np.sum(np.abs(d_hat - data) ** 2) / np.sum(np.abs(data) ** 2)))
    snr_est = 10 * np.log10(np.maximum(out["snr_lin"].cpu().numpy(), 1e-9)).mean()
    print(f"combined 2-antenna link @ {snr_db:.0f} dB: "
          f"symbol errors {sym_errors}/{data.size}, EVM {evm:.3f}, "
          f"est. SNR {snr_est:.1f} dB")
    # at 28 dB this channel sits on an error floor of ~1e-4 of the symbols
    # (4 of 12 noise draws give one error in 3,744; the JAX example's one
    # draw gives none): more than 1e-3 means the combining failed
    if sym_errors > SYMBOL_ERROR_FLOOR * data.size:
        raise RuntimeError("CDD combining failed")
    print("OK: effective CDD channel absorbed by the preamble estimator")
    # larger cyclic shifts make the effective channel oscillate faster
    # across preamble bins than the 9-tap Gaussian smoother
    # (preamble_channel_estimator_cc.cc:145-185) can track - the same
    # limitation the reference QA tolerates with a 5% error proxy
    return {"symbol_errors": sym_errors, "symbols": int(data.size), "evm": evm,
            "snr_est_db": float(snr_est)}


if __name__ == "__main__":
    from gfdm_tpu_torch.examples import parse_device

    main(device=parse_device(__doc__))
