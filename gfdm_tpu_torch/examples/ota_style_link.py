#!/usr/bin/env python3
"""OTA-style protected link (analogue of examples/gfdm_ota_demo.grc).

Byte payloads -> CRC32 -> bits -> QPSK -> Tx chain -> timed burst shaping
-> channel -> sync -> Rx chain -> bits -> CRC check, with tx_time stamps
from the cycle-grid scheduler (no radio hardware required). The port of
examples/ota_style_link.py: the complex-dtype chain on the card
(``--device cpu``: on the CPU); the noise from a CPU torch.Generator.
"""
import numpy as np
import torch

from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.device import resolve_device
from gfdm_tpu_torch.ops import tx as tx_ops
from gfdm_tpu_torch.runtime import channel as chan
from gfdm_tpu_torch.runtime.receiver import receive_stream
from gfdm_tpu_torch.runtime.timing import BurstScheduler
from gfdm_tpu_torch.runtime.transmitter import shape_bursts
from gfdm_tpu_torch.utils.framing import (
    attach_crc32,
    check_crc32,
    pack_bits,
    payload_capacity_bytes,
    unpack_bits,
)


def main(n_bursts=8, snr_db=18.0, device=None):
    dev = resolve_device(device, "ota_style_link")
    cfg = GfdmConfig()
    cap = payload_capacity_bytes(cfg.n_data_symbols)
    print(f"payload capacity: {cap} bytes/burst (+4 CRC)")

    rng = np.random.default_rng(0)
    messages = [bytes(rng.integers(0, 256, cap, dtype=np.uint8)) for _ in range(n_bursts)]

    # frame: CRC -> bits -> QPSK symbols (I-bit, Q-bit per symbol)
    sym_batch = np.empty((n_bursts, cfg.n_data_symbols), dtype=np.complex64)
    for i, msg in enumerate(messages):
        bits = unpack_bits(attach_crc32(msg)).reshape(-1, 2)
        sym_batch[i] = ((1 - 2.0 * bits[:, 0]) + 1j * (1 - 2.0 * bits[:, 1])) / np.sqrt(2)

    bursts = tx_ops.transmit(cfg, sym_batch, device=dev)[:, 0, :]
    shaped = shape_bursts(cfg, bursts, scale=0.7)

    # timed transmission stamps on a 10 ms cycle grid
    sched = BurstScheduler(cycle_interval_secs=0.01, timing_advance_secs=0.0005)
    stamps = [sched.next_tx_time(100, 0.003) for _ in range(n_bursts)]
    print(f"tx_time stamps (first 3): {stamps[:3]}")

    # channel + reception (burst placed at its padded offset per chunk)
    s = chan.multipath(shaped.reshape(n_bursts, -1), np.array([1.0, 0.2 + 0.1j]))
    s = chan.awgn(torch.Generator().manual_seed(5), s, snr_db)
    out = receive_stream(cfg, s, ic_iterations=3)

    d_hat = out["data"].cpu().numpy()
    ok = 0
    for i in range(n_bursts):
        bits = np.stack([d_hat[i].real < 0, d_hat[i].imag < 0], axis=-1).astype(np.uint8)
        crc_ok, payload = check_crc32(pack_bits(bits))
        ok += int(crc_ok and payload == messages[i])
    print(f"CRC-verified bursts: {ok}/{n_bursts} at {snr_db:.0f} dB SNR")
    return {"crc_verified": ok, "bursts": n_bursts, "stamps": stamps}


if __name__ == "__main__":
    from gfdm_tpu_torch.examples import parse_device

    main(device=parse_device(__doc__))
