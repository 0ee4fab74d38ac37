"""The modem's payload framing: bytes <-> CRC-32-protected burst symbols.

The port of the framing half of ``gfdm_tpu.cli``: the constellation lookup,
the per-burst byte capacity and the payload <-> symbol framing with and
without the rate-1/2 K=7 code (``fec="conv"``), bit for bit the reference's
(a payload framed by either package decodes in the other). Encoding is
NumPy; the ``fec="conv"`` decode runs its LLRs and Viterbi as torch ops on
the card, or on the CPU with ``device="cpu"``. The subcommands (info, tx,
rx, simulate) wait for ROADMAP.md Queue 1 item 9.
"""
from __future__ import annotations

import numpy as np

from .config import GfdmConfig
from .utils.framing import (
    attach_crc32,
    check_crc32,
    pack_bits,
    payload_capacity_bytes,
    unpack_bits,
)

__all__ = ["burst_capacity_bytes", "payload_to_symbols", "symbols_to_payloads"]


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
