#!/usr/bin/env python3
"""Continuous-stream reception with the native ring buffer front end.

A producer (stand-in for a radio driver) pushes interleaved sc16 IQ into the
native SPSC ring buffer; the consumer pulls extended chunk batches and runs
the batched planar receiver - the analogue of the reference's
hier_gfdm_fastsync + extract_burst + receiver flowgraph. The port of
examples/stream_receiver.py: the planar pipeline on the card (``--device
cpu``: on the CPU); the host library builds itself with g++ at first use.
"""
import numpy as np
import torch

from gfdm_tpu_torch import GfdmConfig, native
from gfdm_tpu_torch.device import resolve_device
from gfdm_tpu_torch.ops import planar as pl
from gfdm_tpu_torch.ops import planar_pipeline as pp
from gfdm_tpu_torch.ops import tx as tx_ops
from gfdm_tpu_torch.ref import utils


def main(n_bursts=4, chunk_len=2048, device=None):
    dev = resolve_device(device, "stream_receiver")
    cfg = GfdmConfig()

    # --- 'radio' side: synthesize a recording and push it as sc16 ---------
    rng = np.random.default_rng(0)
    data = np.stack(
        [utils.random_qpsk(cfg.n_data_symbols, seed=i) for i in range(n_bursts)]
    ).astype(np.complex64)
    bursts = tx_ops.transmit(cfg, data, device=dev)[:, 0, :].cpu().numpy()
    stream = 0.01 * (
        rng.standard_normal(n_bursts * chunk_len)
        + 1j * rng.standard_normal(n_bursts * chunk_len)
    ).astype(np.complex64)
    for i, b in enumerate(bursts):
        off = i * chunk_len + 200 + 37 * i
        stream[off : off + cfg.frame_len] += 0.5 * b
    raw_sc16 = native.planar_to_sc16(pl.to_planar(stream), scale=2**14)

    halo = cfg.frame_len + cfg.cp_len
    sb = native.StreamBuffer(capacity=16 * chunk_len, chunk_len=chunk_len, halo=halo)
    # push in radio-sized packets
    planar = native.sc16_to_planar(raw_sc16, scale=2**14)
    for i in range(0, planar.shape[-1], 4096):
        sb.push(planar[:, i : i + 4096])

    # --- device side: pull chunk batches, detect + receive -----------------
    chunks, base = sb.pull(16)
    print(f"pulled {chunks.shape[0]} chunks starting at sample {base}")
    x = torch.from_numpy(chunks).to(dev)
    det = pp.detect_bursts_planar(cfg, x, search_limit=chunk_len)
    found = (det["start"] < chunk_len).cpu().numpy()
    bursts_pl = pp.extract_bursts_planar(cfg, x, det)
    out = pp.receive_bursts_planar(cfg, bursts_pl, ic_iterations=3)
    d_hat = pl.from_planar(out["data"].cpu().numpy())[found]
    evm = utils.evm(utils.qpsk_hard_map(d_hat), data[: d_hat.shape[0]])
    print(f"bursts found: {int(found.sum())}/{chunks.shape[0]} pulled chunks "
          f"(last burst stays buffered until its halo is complete)")
    print(f"decision EVM vs tx payload: {evm:.2e}")
    return {"found": int(found.sum()), "pulled": int(chunks.shape[0]), "base": int(base),
            "evm": float(evm), "start": det["start"].cpu().numpy()}


if __name__ == "__main__":
    from gfdm_tpu_torch.examples import parse_device

    main(device=parse_device(__doc__))
