"""The coded modem at service rate: device-side FEC in the receive loop.

A file payload is framed exactly as the CLI does (per-burst CRC-32 + one
rate-1/2 K=7 codeword, interleaved), transmitted as a burst train into a
noisy sample stream, and received by StreamingReceiver(engine="fused",
fec="conv"): one device step runs sync, extraction, the receiver kernel,
planar max-log LLRs, deinterleaving and radix Viterbi - the sink only
CRC-checks bits. The port of examples/coded_service.py, on the card
(``--device cpu``: on the CPU, the kernels' plain versions).

The reference's OTA chain is CRC-only (gr-gfdm/examples/gfdm_ota_demo.grc);
this adds the FEC and keeps it at service rate.
"""
import numpy as np
import torch

from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.cli import burst_capacity_bytes, payload_to_symbols
from gfdm_tpu_torch.device import resolve_device
from gfdm_tpu_torch.ops.planar_pipeline import prepare, transmit_planar
from gfdm_tpu_torch.runtime.service import StreamingReceiver
from gfdm_tpu_torch.utils.framing import check_crc32, pack_bits


def main(n_bursts=6, snr_db=10.0, device=None):
    dev = resolve_device(device, "coded_service")
    cfg = GfdmConfig()
    chunk_len = 2048
    cap = burst_capacity_bytes(cfg, 2, "conv")
    payload = (b"GFDM coded service demo payload. " * 64)[: n_bursts * cap - 9]
    syms, n_bursts = payload_to_symbols(cfg, payload, "qpsk", fec="conv")
    print(f"payload {len(payload)} bytes -> {n_bursts} coded bursts "
          f"({cap} bytes each + CRC)")

    prepare(cfg, device=dev)
    planar = np.stack([syms.real, syms.imag], axis=1).astype(np.float32)
    bursts = transmit_planar(cfg, torch.from_numpy(planar).to(dev))[:, 0].cpu().numpy()
    halo = cfg.frame_len + cfg.cp_len
    rng = np.random.default_rng(1)
    sig = float(np.mean(np.sum(bursts**2, axis=1)))
    na = np.sqrt(sig * 10 ** (-snr_db / 10) / 2)
    chunks = (na * rng.standard_normal((n_bursts, 2, chunk_len + halo))).astype(np.float32)
    offs = rng.integers(0, chunk_len - cfg.cp_len, n_bursts)
    for i in range(n_bursts):
        chunks[i, :, offs[i] : offs[i] + cfg.frame_len] += bursts[i]

    rx = StreamingReceiver(cfg, chunk_len=chunk_len, batch_chunks=n_bursts,
                           engine="fused", fec="conv", device=dev)
    out = rx.step(chunks)
    got, ok_count = b"", 0
    for found, bits in zip(out["found"], out["bits"]):
        if not found:
            continue
        ok, part = check_crc32(pack_bits(bits[: (cap + 4) * 8]))
        ok_count += ok
        got += part
    n_found = int(out["found"].sum())
    intact = got[: len(payload)] == payload
    print(f"bursts found: {n_found}/{n_bursts}, "
          f"CRC-clean: {ok_count}/{n_bursts} at {snr_db:.0f} dB SNR")
    print(f"payload intact: {intact}")
    return {"found": n_found, "crc_clean": int(ok_count), "bursts": n_bursts,
            "intact": intact}


if __name__ == "__main__":
    from gfdm_tpu_torch.examples import parse_device

    main(device=parse_device(__doc__))
