#!/usr/bin/env python3
"""End-to-end GFDM link simulation (analogue of gfdm_simulation_demo.grc).

Payload bits -> Tx chain -> multipath + CFO + AWGN channel -> sync ->
burst extraction -> channel estimation -> ZF + IC receiver -> bits,
with per-burst SNR/EVM reporting. The port of examples/loopback_simulation.py:
the complex-dtype chain on the card (``--device cpu``: on the CPU); the
noise from a CPU torch.Generator seeded as the JAX script seeds its key.
"""
import numpy as np
import torch

from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.device import resolve_device
from gfdm_tpu_torch.ops import tx as tx_ops
from gfdm_tpu_torch.ref import utils
from gfdm_tpu_torch.runtime import channel as chan
from gfdm_tpu_torch.runtime.receiver import receive_stream


def main(batch=32, snr_db=20.0, cfo=0.03, device=None):
    dev = resolve_device(device, "loopback_simulation")
    cfg = GfdmConfig()
    print(f"config: M={cfg.timeslots} K={cfg.subcarriers} "
          f"active={cfg.active_subcarriers} cp={cfg.cp_len} "
          f"frame_len={cfg.frame_len}")

    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (batch, cfg.n_data_symbols, 2))
    data = ((1 - 2 * bits[..., 0]) + 1j * (1 - 2 * bits[..., 1])) / np.sqrt(2)
    data = data.astype(np.complex64)

    bursts = tx_ops.transmit(cfg, data, device=dev)[:, 0, :]

    chunk_len = 2048
    offset = 400
    stream = bursts.new_zeros((batch, chunk_len))
    stream[:, offset : offset + cfg.frame_len] = bursts
    s = chan.multipath(stream, np.array([1.0, 0.25 + 0.15j, 0.1]))
    s = chan.apply_cfo(s, cfo, cfg.subcarriers)
    s = chan.awgn(torch.Generator().manual_seed(1), s, snr_db)

    out = receive_stream(cfg, s, ic_iterations=4)
    d_hat = out["data"].cpu().numpy()
    rx_bits = np.stack([d_hat.real < 0, d_hat.imag < 0], axis=-1).astype(int)

    ber = np.mean(rx_bits != bits)
    evm = utils.evm(d_hat, data)
    snr_est = 10 * np.log10(np.mean(out["snr_lin"].cpu().numpy()))
    det = {k: out["detection"][k].cpu().numpy() for k in ("start", "cfo")}
    print(f"detected starts: {det['start'][:4]}... "
          f"(expected {offset + cfg.cp_len})")
    print(f"CFO estimates: {det['cfo'][:4]} (true {cfo})")
    print(f"BER={ber:.5f}  EVM={evm:.4f}  est. SNR={snr_est:.1f} dB")
    return {"ber": float(ber), "evm": float(evm), "snr_est_db": float(snr_est),
            "start": det["start"], "expected_start": offset + cfg.cp_len, "cfo": det["cfo"]}


if __name__ == "__main__":
    from gfdm_tpu_torch.examples import parse_device

    main(device=parse_device(__doc__))
