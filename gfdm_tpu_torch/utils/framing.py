"""Payload framing helpers: bit (un)packing and CRC-32 protection.

A verbatim copy of ``gfdm_tpu.utils.framing`` (pure NumPy and zlib), kept in
the port so it imports nothing of the JAX package. The reference's OTA demo
builds its payload path from stock GR blocks (stream CRC32, repack bits -
gr-gfdm/examples/gfdm_ota_demo.grc); these are the framework-native
equivalents so an end-to-end protected link needs no external components.
"""
from __future__ import annotations

import zlib

import numpy as np

__all__ = ["pack_bits", "unpack_bits", "attach_crc32", "check_crc32", "payload_capacity_bytes"]


def pack_bits(bits: np.ndarray) -> bytes:
    """MSB-first bit array (0/1) -> bytes (length must be a multiple of 8)."""
    bits = np.asarray(bits, dtype=np.uint8).reshape(-1)
    if bits.size % 8:
        raise ValueError("bit count must be a multiple of 8")
    return np.packbits(bits).tobytes()


def unpack_bits(data: bytes, n_bits: int | None = None) -> np.ndarray:
    """bytes -> MSB-first bit array (optionally truncated to n_bits)."""
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
    return bits[:n_bits] if n_bits is not None else bits


def attach_crc32(payload: bytes) -> bytes:
    """payload ++ CRC-32 (little-endian, zlib polynomial)."""
    return payload + zlib.crc32(payload).to_bytes(4, "little")


def check_crc32(frame: bytes) -> tuple[bool, bytes]:
    """(crc_ok, payload) for a frame produced by attach_crc32."""
    if len(frame) < 4:
        return False, b""
    payload, crc = frame[:-4], frame[-4:]
    return zlib.crc32(payload).to_bytes(4, "little") == crc, payload


def payload_capacity_bytes(n_data_symbols: int, bits_per_symbol: int = 2) -> int:
    """Usable payload bytes per burst after the 4-byte CRC."""
    return (n_data_symbols * bits_per_symbol) // 8 - 4
