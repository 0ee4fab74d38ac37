"""Streaming service demo: native file ingest -> the receive service.

Writes a synthetic sc16 capture with several GFDM bursts, ingests it with
the native background reader thread, and serves it through the persistent
StreamingReceiver on its device mesh (one device here; without ``device``
every visible card). The production counterpart of the reference's
running receive flowgraph (examples/hier_gfdm_receiver_tagged.grc + a
file/UHD source). The port of examples/streaming_service.py, on the card
(``--device cpu``: on the CPU); the host library builds itself with g++ at
first use.
"""
import os
import tempfile
import time

import numpy as np

from gfdm_tpu_torch import GfdmConfig, native
from gfdm_tpu_torch.device import resolve_device
from gfdm_tpu_torch.ops import planar as pl
from gfdm_tpu_torch.ops import tx as tx_ops
from gfdm_tpu_torch.ref import utils
from gfdm_tpu_torch.runtime.service import StreamingReceiver


def main(n_chunks=16, n_bursts=6, device=None):
    dev = resolve_device(device, "streaming_service")
    cfg = GfdmConfig()
    chunk_len = 2048
    halo = cfg.frame_len + cfg.cp_len

    # --- synthesize a capture: bursts at staggered offsets + noise ---------
    rng = np.random.default_rng(0)
    payloads = np.stack(
        [utils.random_qpsk(cfg.n_data_symbols, seed=i) for i in range(n_bursts)]
    ).astype(np.complex64)
    bursts = tx_ops.transmit(cfg, payloads, device=dev)[:, 0, :].cpu().numpy()
    stream = 0.004 * (
        rng.standard_normal(n_chunks * chunk_len)
        + 1j * rng.standard_normal(n_chunks * chunk_len)
    ).astype(np.complex64)
    offsets = [(2 * i + 1) * chunk_len + 37 * i for i in range(n_bursts)]
    for b, off in zip(bursts, offsets):
        stream[off : off + cfg.frame_len] += 0.5 * b

    fd, path = tempfile.mkstemp(suffix=".sc16")
    os.close(fd)
    try:
        native.planar_to_sc16(pl.to_planar(stream), scale=8000.0).tofile(path)

        # --- native ingest thread feeds the ring; the service drains it ----
        sb = native.StreamBuffer(capacity=4 * n_chunks * chunk_len,
                                 chunk_len=chunk_len, halo=halo)
        ingest = native.FileIngest(path, sb, scale=8000.0)

        rx = StreamingReceiver(cfg, chunk_len=chunk_len, batch_chunks=8, device=dev)
        print(f"mesh: dp={rx.mesh.shape['dp']} devices, chunk={chunk_len}, "
              f"halo={halo}")

        recovered = []

        def sink(out):
            found = out["found"]
            for row, start in zip(pl.from_planar(out["data"][found]),
                                  out["start_abs"][found]):
                recovered.append((int(start), row))

        while ingest.running:
            time.sleep(0.005)
        samples = ingest.finish()
        stats = rx.serve(sb, sink=sink)
    finally:
        os.unlink(path)

    print(f"ingested {samples} samples; served {stats.batches} batches / "
          f"{stats.chunks} chunks; bursts found: {stats.bursts_found}")
    # the host's split of the loop: each phase's span, ms a batch
    split = ", ".join(f"{name.removeprefix('gfdm.service.')} {s * 1e3 / stats.batches:.2f}"
                      for name, s in sorted(stats.host_s.items(), key=lambda kv: -kv[1]))
    print(f"host ms a batch: {split}")
    recovered.sort(key=lambda sr: sr[0])
    errs = 0
    for (start, row), off, ref in zip(recovered, offsets, payloads):
        hard = utils.qpsk_hard_map(row)
        errs += int(np.sum(np.abs(hard - ref) > 0.1))
        if start != off + cfg.cp_len:
            raise RuntimeError(f"burst at {off} detected at {start}, expected "
                               f"{off + cfg.cp_len}")
    print(f"symbol errors across {n_bursts} bursts: {errs}  "
          f"(mean est. SNR {stats.mean_snr_db:.1f} dB)")
    return {"found": stats.bursts_found, "bursts": n_bursts, "symbol_errors": errs,
            "starts": [s for s, _ in recovered], "expected_starts":
            [off + cfg.cp_len for off in offsets], "dp": rx.mesh.shape["dp"],
            "ingested": samples, "host_s": dict(stats.host_s)}


if __name__ == "__main__":
    from gfdm_tpu_torch.examples import parse_device

    main(device=parse_device(__doc__))
