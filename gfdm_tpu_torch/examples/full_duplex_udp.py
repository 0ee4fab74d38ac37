#!/usr/bin/env python3
"""Full-duplex modem over a real UDP socket: the OTA demo, software edition.

StreamingTransmitter modulates payload batches (the Tx kernel) onto a timed
cycle grid and sends them as sc16 datagrams (UdpSink = the uhd_usrp_sink
analogue); the native UdpIngest thread receives them into the
chunk-framing ring, and StreamingReceiver detects, extracts and
demodulates every burst. The executable counterpart of the reference's
USRP OTA flowgraph (gr-gfdm/examples/gfdm_ota_demo.grc) with UDP in place
of the radio driver. The port of examples/full_duplex_udp.py, on the card
(``--device cpu``: on the CPU); the host library builds itself with g++ at
first use.
"""
import numpy as np

from gfdm_tpu_torch import GfdmConfig, native
from gfdm_tpu_torch.device import resolve_device
from gfdm_tpu_torch.ops import planar as pl
from gfdm_tpu_torch.ref import utils
from gfdm_tpu_torch.runtime.service import StreamingReceiver
from gfdm_tpu_torch.runtime.transmit_service import StreamingTransmitter, UdpSink


def main(n_bursts=12, port=47633, chunk_len=2048, device=None):
    dev = resolve_device(device, "full_duplex_udp")
    cfg = GfdmConfig()
    halo = cfg.frame_len + cfg.cp_len

    data = np.stack([utils.random_qpsk(cfg.n_data_symbols, seed=i) for i in range(n_bursts)])
    payloads = pl.to_planar(data).astype(np.float32)

    ring = native.StreamBuffer(capacity=64 * chunk_len, chunk_len=chunk_len, halo=halo)
    ingest = native.UdpIngest(port, ring)

    tx = StreamingTransmitter(cfg, batch_bursts=4, scale=0.5, device=dev)
    sink = UdpSink(port)
    batches = iter([payloads[i : i + 4] for i in range(0, n_bursts, 4)])
    tx.serve(lambda: next(batches, None), sink)
    sink.push(np.zeros((2, halo), np.float32))  # flush the tail chunk
    sink.close()
    n_in = ingest.finish()
    print(f"tx: {tx.stats.bursts} bursts / {tx.stats.samples} samples in "
          f"{sink.datagrams_sent} datagrams; rx ingested {n_in} samples")

    rx = StreamingReceiver(cfg, chunk_len=chunk_len, batch_chunks=4, device=dev)
    outs = []
    rx.serve(ring, outs.append)
    found = np.concatenate([o["found"] for o in outs])
    starts = np.concatenate([o["start_abs"] for o in outs])
    d_hat = pl.from_planar(np.concatenate([o["data"] for o in outs])[found])
    order = np.argsort(starts[found])
    evm = utils.evm(utils.qpsk_hard_map(d_hat[order]), data)
    print(f"rx: {int(found.sum())}/{n_bursts} bursts recovered, "
          f"decision EVM {evm:.2e}")
    return {"found": int(found.sum()), "bursts": n_bursts, "evm": float(evm),
            "ingested": n_in, "sent": tx.stats.samples, "datagrams": sink.datagrams_sent}


if __name__ == "__main__":
    from gfdm_tpu_torch.examples import parse_device

    main(device=parse_device(__doc__))
