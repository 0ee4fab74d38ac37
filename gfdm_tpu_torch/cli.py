"""Command-line GFDM modem: the application layer (the port of ``gfdm_tpu.cli``).

The reference ships its applications as GRC flowgraphs
(gr-gfdm/examples/gfdm_ota_demo.grc: CRC32 -> repack bits -> mapper ->
transmitter -> USRP, and the reverse chain). This module is their
counterpart as a self-contained CLI on the card:

    python -m gfdm_tpu_torch info                        # derived constants
    python -m gfdm_tpu_torch tx  --infile p.bin --outfile iq.cf32
    python -m gfdm_tpu_torch rx  --infile iq.cf32 --outfile out.bin
    python -m gfdm_tpu_torch simulate --bursts 64 --snr-db 12
    python -m gfdm_tpu_torch --device cpu simulate       # on the CPU

(``gfdm-tpu-torch`` is the installed console script.) `tx` packs a byte
file into CRC-32-protected bursts and writes an IQ sample stream (cf32
interleaved float32 or sc16); `rx` runs the full receiver (sync -> burst
extraction -> channel estimation -> ZF + IC -> demap -> CRC check) and
writes back the recovered payload bytes; `simulate` closes the loop through
a multipath + AWGN channel without touching the filesystem. Files written
by either package's `tx` decode in the other's `rx`.

The modem math runs as complex64 torch ops on ``--device`` (default
``cuda``; ``--device cpu`` runs it on the CPU); without a card and without
``--device cpu`` the modem commands exit with a usage error. The framing
(bytes <-> CRC-32-protected burst symbols, with and without the rate-1/2
K=7 code) is NumPy, bit for bit the reference's; the ``fec="conv"`` decode
runs its LLRs and Viterbi as torch ops on the device.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .config import GfdmConfig
from .utils.converter import SC16_SCALE, cf64_to_sc16, sc16_to_cf64
from .utils.framing import (
    attach_crc32,
    check_crc32,
    pack_bits,
    payload_capacity_bytes,
    unpack_bits,
)

__all__ = ["main", "build_config", "tx_file", "rx_file", "simulate", "burst_capacity_bytes",
           "payload_to_symbols", "symbols_to_payloads"]


# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------
def add_config_args(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("waveform")
    g.add_argument("--timeslots", "-M", type=int, default=9)
    g.add_argument("--subcarriers", "-K", type=int, default=64)
    g.add_argument("--active-subcarriers", type=int, default=52)
    g.add_argument("--overlap", "-L", type=int, default=2)
    g.add_argument("--cp-len", type=int, default=16)
    g.add_argument("--cs-len", type=int, default=8)
    g.add_argument("--filteralpha", type=float, default=0.2)
    g.add_argument("--constellation", choices=("qpsk", "qam16", "qam64"), default="qpsk",
                   help="payload symbol mapping (qam16/qam64 = 2x/3x bytes/burst)")


def build_config(args: argparse.Namespace) -> GfdmConfig:
    return GfdmConfig(
        timeslots=args.timeslots,
        subcarriers=args.subcarriers,
        active_subcarriers=args.active_subcarriers,
        overlap=args.overlap,
        cp_len=args.cp_len,
        cs_len=args.cs_len,
        filteralpha=args.filteralpha,
    )


def _read_iq(path: str, fmt: str) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.int16 if fmt == "sc16" else np.float32)
    # A truncated capture can end mid-sample; drop the trailing scalar in
    # both formats rather than crashing on an odd-length reshape.
    raw = raw[: raw.size // 2 * 2]
    if fmt == "sc16":
        return sc16_to_cf64(raw).astype(np.complex64)
    return raw.view(np.complex64)


def _write_iq(path: str, samples: np.ndarray, fmt: str) -> None:
    if fmt == "sc16":
        peak = float(max(np.abs(samples.real).max(), np.abs(samples.imag).max())) if samples.size else 0.0
        if peak * SC16_SCALE > 32767:
            print(
                f"warning: sc16 clipping (peak |component| {peak:.3f} > "
                f"{32767 / SC16_SCALE:.6f}); reduce --scale to avoid burst corruption",
                file=sys.stderr,
            )
        cf64_to_sc16(samples.astype(np.complex128)).tofile(path)
    else:
        samples.astype(np.complex64).view(np.float32).tofile(path)


# ---------------------------------------------------------------------------
# payload <-> symbol framing (QPSK / Gray QAM, CRC-32 per burst)
# ---------------------------------------------------------------------------


def _constellation(name: str) -> tuple[np.ndarray, int]:
    """(points, bits per symbol) for a named constellation."""
    from .ops.rx import constellation_points

    pts = constellation_points(name)
    return pts, int(np.log2(pts.size))


def burst_capacity_bytes(cfg: GfdmConfig, order: int, fec: str = "none") -> int:
    """Payload bytes per burst (after the 4-byte CRC; after FEC if any).

    fec="conv": one rate-1/2 zero-terminated codeword per burst (coding.py)
    - roughly half the uncoded capacity.
    """
    if fec == "conv":
        from .coding import info_bits_for_block

        n_bits = order * cfg.n_data_symbols
        if n_bits % 2:
            # the rate-1/2 codeword 2*(n_info+6) is always even, so an odd
            # bit budget cannot be filled exactly
            raise ValueError(
                "fec='conv' needs an even bits-per-burst budget; "
                f"order {order} x n_data_symbols {cfg.n_data_symbols} "
                f"gives {n_bits} (odd)"
            )
        return info_bits_for_block(n_bits) // 8 - 4
    return payload_capacity_bytes(cfg.n_data_symbols, order)


def payload_to_symbols(
    cfg: GfdmConfig, payload: bytes, constellation: str = "qpsk",
    fec: str = "none",
) -> tuple[np.ndarray, int]:
    """File bytes -> (n_bursts, n_data_symbols) symbols with per-burst CRC-32.

    The final burst is zero-padded to capacity; returns the complex64 symbol
    batch and the number of bursts. ``fec="conv"``: each burst carries one
    interleaved rate-1/2 K=7 codeword (half the bytes, soft-decoded on
    receive).
    """
    from .ref import symbolmapping as sm

    if fec not in ("none", "conv"):
        raise ValueError(f"unknown fec {fec!r}")
    pts, order = _constellation(constellation)
    cap = burst_capacity_bytes(cfg, order, fec)
    if cap <= 0:
        raise ValueError("configuration too small to carry a CRC-framed payload")
    n_bursts = max(1, -(-len(payload) // cap))
    padded = payload + b"\x00" * (n_bursts * cap - len(payload))
    n_bits = order * cfg.n_data_symbols
    if fec == "conv":
        from .coding import conv_encode, info_bits_for_block, interleaver

        n_info = info_bits_for_block(n_bits)
        perm = interleaver(n_bits)
    out = np.empty((n_bursts, cfg.n_data_symbols), dtype=np.complex64)
    for i in range(n_bursts):
        frame = attach_crc32(padded[i * cap : (i + 1) * cap])
        bits = unpack_bits(frame)
        if fec == "conv":
            info = np.concatenate([bits, np.zeros(n_info - bits.size, np.uint8)])
            bits = conv_encode(info)[perm]
        else:
            bits = np.concatenate([bits, np.zeros(n_bits - bits.size, np.uint8)])
        out[i] = sm.bits_to_symbols(bits, pts)
    return out, n_bursts


def symbols_to_payloads(
    cfg: GfdmConfig, symbols: np.ndarray, constellation: str = "qpsk",
    fec: str = "none", snr_lin: np.ndarray | None = None, device=None,
) -> list[tuple[bool, bytes]]:
    """Symbols back to (crc_ok, payload) per burst.

    fec="none": hard decisions (NumPy). fec="conv": max-log LLRs (noise
    variance from the per-burst ``snr_lin`` estimate when given) -> batched
    soft-decision Viterbi -> CRC check, the LLRs and the decoder on
    ``device`` (default: the card; without one it raises).
    """
    from .ref import symbolmapping as sm

    pts, order = _constellation(constellation)
    cap = burst_capacity_bytes(cfg, order, fec)
    rows = np.atleast_2d(symbols)
    if fec == "conv":
        import torch

        from .coding import info_bits_for_block, interleaver, viterbi_decode
        from .device import resolve_device
        from .ops.softbits import maxlog_llrs

        dev = resolve_device(device, "symbols_to_payloads")
        n_bits = order * cfg.n_data_symbols
        n_info = info_bits_for_block(n_bits)
        inv = np.argsort(interleaver(n_bits))
        nv = (1.0 / np.maximum(np.asarray(snr_lin, np.float32), 1e-6)
              if snr_lin is not None else np.ones(rows.shape[0], np.float32))
        llrs = maxlog_llrs(rows.astype(np.complex64), pts, nv[:, None], device=dev)
        llrs = llrs.reshape(rows.shape[0], -1)[:, torch.as_tensor(inv, device=dev)]
        bits_all = viterbi_decode(llrs, n_info).cpu().numpy()
        return [check_crc32(pack_bits(bits[: (cap + 4) * 8])) for bits in bits_all]
    results = []
    for row in rows:
        bits = sm.symbols_to_bits(row, pts).astype(np.uint8)
        frame = pack_bits(bits[: (cap + 4) * 8])
        results.append(check_crc32(frame))
    return results


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------
def cmd_info(args: argparse.Namespace) -> int:
    cfg = build_config(args)
    print(
        json.dumps(
            {
                "timeslots": cfg.timeslots,
                "subcarriers": cfg.subcarriers,
                "active_subcarriers": cfg.active_subcarriers,
                "overlap": cfg.overlap,
                "cp_len": cfg.cp_len,
                "cs_len": cfg.cs_len,
                "block_len": cfg.block_len,
                "preamble_len": cfg.preamble_len,
                "frame_len": cfg.frame_len,
                "padded_frame_len": cfg.padded_frame_len,
                "n_data_symbols": cfg.n_data_symbols,
                "constellation": args.constellation,
                "payload_bytes_per_burst": payload_capacity_bytes(
                    cfg.n_data_symbols, _constellation(args.constellation)[1]
                ),
            },
            indent=2,
        )
    )
    return 0


def _tx_stream(cfg: GfdmConfig, payload: bytes, scale: float, constellation: str,
               fec: str, device):
    """Byte payload -> (n_bursts, padded_frame_len) complex64 tensor on the
    device: framing (NumPy), then Tx and padding as torch ops."""
    from .ops import tx as tx_ops
    from .runtime.transmitter import shape_bursts

    data, _ = payload_to_symbols(cfg, payload, constellation, fec=fec)
    bursts = tx_ops.transmit(cfg, data, device=device)[:, 0, :]
    return shape_bursts(cfg, bursts, scale=scale)


def tx_file(cfg: GfdmConfig, payload: bytes, scale: float = 0.7,
            constellation: str = "qpsk", fec: str = "none", device=None) -> np.ndarray:
    """Byte payload -> contiguous complex64 IQ stream (one padded burst per
    chunk), computed on ``device`` (default: the card; without one it
    raises)."""
    stream = _tx_stream(cfg, payload, scale, constellation, fec, device)
    return stream.reshape(-1).cpu().numpy()


def default_ic_iterations(constellation: str) -> int:
    """Decision-directed SIC passes needed for clean-channel convergence.

    The GFDM self-interference scales with symbol energy, so the denser the
    grid the more passes until residual < half the decision distance: 2
    suffices for qpsk/qam16, 64-QAM needs 4 (measured on the canonical
    config). The reference QA's ic=64 in
    gr-gfdm/python/qa_advanced_receiver_sb_cc.py:82-119 is 64 IC passes on
    QPSK symbols, not a 64-QAM setting."""
    return 4 if constellation == "qam64" else 2


def _decode(cfg: GfdmConfig, out: dict, constellation: str, fec: str, device):
    """receive_stream's output -> (crc_ok, payload) a burst, and the SNRs."""
    snr = out["snr_lin"].cpu().numpy()
    decoded = symbols_to_payloads(
        cfg, out["data"].cpu().numpy(), constellation, fec=fec, snr_lin=snr,
        device=device,
    )
    return decoded, snr.astype(np.float64)


def rx_file(
    cfg: GfdmConfig, stream: np.ndarray, ic_iterations: int | None = None,
    constellation: str = "qpsk", fec: str = "none", device=None,
) -> tuple[bytes, dict]:
    """IQ stream -> (recovered bytes from CRC-valid bursts, stats dict).

    The receiver runs on ``device`` (default: the card; without one it
    raises)."""
    from .device import resolve_device
    from .runtime.receiver import receive_stream

    dev = resolve_device(device, "rx_file")
    if ic_iterations is None:
        ic_iterations = default_ic_iterations(constellation)

    chunk = cfg.padded_frame_len
    n = stream.size // chunk
    if n == 0:
        raise ValueError(
            f"stream too short: {stream.size} samples < one padded frame ({chunk})"
        )
    out = receive_stream(
        cfg, stream[: n * chunk].reshape(n, chunk), ic_iterations=ic_iterations,
        constellation=_constellation(constellation)[0], device=dev,
    )
    decoded, snr = _decode(cfg, out, constellation, fec, dev)
    payload = b"".join(p for ok, p in decoded if ok)
    dropped = int(stream.size - n * chunk)
    if dropped:
        print(
            f"warning: discarding {dropped} trailing samples "
            f"(< one padded frame of {chunk}); capture may be truncated",
            file=sys.stderr,
        )
    stats = {
        "bursts": n,
        "crc_ok": sum(ok for ok, _ in decoded),
        "snr_db_mean": round(float(10 * np.log10(np.maximum(snr, 1e-12)).mean()), 2),
        "bytes": len(payload),
        "discarded_samples": dropped,
    }
    return payload, stats


def cmd_tx(args: argparse.Namespace) -> int:
    cfg = build_config(args)
    if args.infile == "-":
        payload = sys.stdin.buffer.read()
    else:
        with open(args.infile, "rb") as f:
            payload = f.read()
    stream = tx_file(cfg, payload, scale=args.scale, constellation=args.constellation,
                     fec=args.fec, device=args.device)
    _write_iq(args.outfile, stream, args.iq_format)
    print(
        json.dumps(
            {
                "bursts": stream.size // cfg.padded_frame_len,
                "samples": int(stream.size),
                "iq_format": args.iq_format,
            }
        ),
        file=sys.stderr,
    )
    return 0


def rx_udp(port: int, timeout_s: float = 30.0,
           max_samples: int = 1 << 24) -> np.ndarray:
    """Receive an sc16 IQ stream from UDP datagrams on 127.0.0.1:``port``.

    The native ingest thread (gfdm_tpu_torch.native.UdpIngest) converts and
    buffers without Python in the loop - the UHD/VITA-49 recv-thread
    analogue of the reference's OTA demo source
    (gr-gfdm/examples/gfdm_ota_demo.grc uhd_usrp_source). A zero-length
    datagram marks end-of-stream; otherwise capture stops after
    ``timeout_s``. The ring holds ``max_samples``; whole chunks are pulled
    from it while the capture runs, so a longer stream passes through.
    """
    import time

    from . import native

    if not native.available():
        raise RuntimeError("native runtime unavailable")
    chunk = 4096
    sb = native.StreamBuffer(capacity=max_samples + 2 * chunk, chunk_len=chunk, halo=0)
    ing = native.UdpIngest(port, sb)
    parts = []

    def drain():
        while True:
            chunks, _base = sb.pull(64)
            if chunks.size == 0:
                return
            parts.append(chunks[:, 0, :chunk] + 1j * chunks[:, 1, :chunk])

    deadline = time.monotonic() + timeout_s
    while ing.running and time.monotonic() < deadline:
        drain()
        time.sleep(0.01)
    ing.stop()
    n = ing.finish()
    # flush the ring's final partial chunk with zero padding so every
    # received sample sits in a complete pullable chunk
    sb.push(np.zeros((2, chunk), np.float32))
    drain()
    stream = (np.concatenate(parts).reshape(-1)[:n]
              if parts else np.zeros(0, np.complex64))
    return stream.astype(np.complex64)


def cmd_rx(args: argparse.Namespace) -> int:
    cfg = build_config(args)
    if args.udp_port is not None:
        stream = rx_udp(args.udp_port, timeout_s=args.udp_timeout)
        print(f"captured {stream.size} samples from udp:{args.udp_port}",
              file=sys.stderr)
    elif args.infile:
        stream = _read_iq(args.infile, args.iq_format)
    else:
        print("rx: one of --infile or --udp-port is required", file=sys.stderr)
        return 2
    payload, stats = rx_file(cfg, stream, ic_iterations=args.ic,
                             constellation=args.constellation, fec=args.fec,
                             device=args.device)
    if args.outfile == "-":
        sys.stdout.buffer.write(payload)
    else:
        with open(args.outfile, "wb") as f:
            f.write(payload)
    print(json.dumps(stats), file=sys.stderr)
    return 0 if stats["crc_ok"] == stats["bursts"] else 1


SIM_TAPS = np.array([1.0, 0.25 + 0.15j, -0.1j])  # simulate's 3-tap multipath


def simulate(
    cfg: GfdmConfig,
    n_bursts: int = 16,
    snr_db: float = 15.0,
    ic_iterations: int | None = None,
    multipath: bool = True,
    seed: int = 0,
    constellation: str = "qpsk",
    fec: str = "none",
    device=None,
) -> dict:
    """Random-payload loopback through multipath + AWGN; returns stats.

    ``snr_db`` sets noise relative to mean power over the whole padded
    chunk; ``snr_db_est`` is the receiver's per-active-subcarrier estimate
    in the preamble band (the reference's snr_lin tag convention,
    gr-gfdm/lib/preamble_channel_estimator_cc.cc:187-235), which sits ~9-10
    dB above nominal here (padding occupancy + preamble power + bin
    concentration). The two track dB-for-dB.

    The link runs on ``device`` (default: the card; without one it raises).
    The payload comes from NumPy's generator seeded by ``seed``, as in the
    JAX package; the noise from a CPU ``torch.Generator`` seeded by
    ``seed``, moved to the device, so the card and the CPU see the same
    noise (it differs from the JAX package's ``jax.random`` draw).
    """
    import torch

    from .device import resolve_device
    from .runtime import channel as chan
    from .runtime.receiver import receive_stream

    dev = resolve_device(device, "simulate")
    if ic_iterations is None:
        ic_iterations = default_ic_iterations(constellation)
    pts, order = _constellation(constellation)
    cap = burst_capacity_bytes(cfg, order, fec)
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, n_bursts * cap, dtype=np.uint8).tobytes()
    s = _tx_stream(cfg, payload, 0.7, constellation, fec, dev)
    if multipath:
        s = chan.multipath(s, SIM_TAPS)
    s = chan.awgn(torch.Generator().manual_seed(seed), s, snr_db)
    out = receive_stream(cfg, s, ic_iterations=ic_iterations, constellation=pts)
    decoded, snr = _decode(cfg, out, constellation, fec, dev)
    got = b"".join(p for ok, p in decoded if ok)
    sent_bits = np.unpackbits(np.frombuffer(payload, np.uint8))
    ber_bits = 0
    for i, (ok, p) in enumerate(decoded):
        if ok:
            ber_bits += int(
                (
                    np.unpackbits(np.frombuffer(p, np.uint8))
                    != sent_bits[i * cap * 8 : (i + 1) * cap * 8]
                ).sum()
            )
    return {
        "bursts": n_bursts,
        "crc_ok": sum(ok for ok, _ in decoded),
        "payload_intact": got == payload,
        "residual_bit_errors": ber_bits,
        "snr_db_true": snr_db,
        "snr_db_est": round(float(10 * np.log10(np.maximum(snr, 1e-12)).mean()), 2),
    }


def cmd_simulate(args: argparse.Namespace) -> int:
    cfg = build_config(args)
    stats = simulate(
        cfg,
        n_bursts=args.bursts,
        snr_db=args.snr_db,
        ic_iterations=args.ic,
        multipath=not args.no_multipath,
        seed=args.seed,
        constellation=args.constellation,
        fec=args.fec,
        device=args.device,
    )
    print(json.dumps(stats))
    return 0 if stats["crc_ok"] == stats["bursts"] else 1


# ---------------------------------------------------------------------------
def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="gfdm_tpu_torch", description=__doc__.split("\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="torch device of the modem math (default: cuda; cpu runs it on "
                        "the CPU)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def command(name: str, help: str, fn):
        sp = sub.add_parser(name, help=help)
        add_config_args(sp)
        sp.set_defaults(fn=fn)
        return sp

    command("info", "print derived waveform constants", cmd_info)

    pt = command("tx", "bytes -> IQ sample file", cmd_tx)
    pt.add_argument("--infile", required=True, help="payload file ('-' = stdin)")
    pt.add_argument("--outfile", required=True, help="IQ output file")
    pt.add_argument("--iq-format", choices=("cf32", "sc16"), default="cf32")
    pt.add_argument("--scale", type=float, default=0.7)
    pt.add_argument("--fec", choices=("none", "conv"), default="none",
                    help="rate-1/2 K=7 convolutional FEC per burst")

    pr = command("rx", "IQ sample file (or UDP) -> recovered bytes", cmd_rx)
    pr.add_argument("--infile", help="IQ input file")
    pr.add_argument("--outfile", required=True, help="payload output ('-' = stdout)")
    pr.add_argument("--iq-format", choices=("cf32", "sc16"), default="cf32")
    pr.add_argument("--ic", type=int, default=None,
                    help="IC iterations (default 2; 4 for qam64, whose "
                         "denser grid needs more SIC passes to converge)")
    pr.add_argument("--udp-port", type=int, default=None,
                    help="receive sc16 IQ datagrams on 127.0.0.1:PORT instead "
                         "of reading --infile (end capture with an empty "
                         "datagram or after --udp-timeout seconds)")
    pr.add_argument("--udp-timeout", type=float, default=30.0)
    pr.add_argument("--fec", choices=("none", "conv"), default="none",
                    help="soft-decision Viterbi decode (must match tx)")

    ps = command("simulate", "loopback link through a simulated channel", cmd_simulate)
    ps.add_argument("--bursts", type=int, default=16)
    ps.add_argument("--snr-db", type=float, default=15.0)
    ps.add_argument("--ic", type=int, default=None)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--no-multipath", action="store_true")
    ps.add_argument("--fec", choices=("none", "conv"), default="none")

    args = p.parse_args(argv)
    if args.fn is not cmd_info and args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            p.error("no CUDA device; pass --device cpu to run the modem on the CPU")
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
