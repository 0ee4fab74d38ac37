"""ctypes bindings for the native host runtime (``csrc/gfdm_host.cpp``).

The port of ``gfdm_tpu.native``: wire-format conversion (sc16 <-> planar
float32), payload bit packing, a single-producer stream ring that frames
continuous IQ into halo-extended chunk batches for the receive service, a
bank of such rings for multi-channel pulls, and the native reader threads
that feed a ring from an sc16 file or from UDP datagrams.

``csrc/gfdm_host.cpp`` is a byte-equal copy of the JAX package's
``native/gfdm_host.cpp``. It is compiled with g++ at first use into
``kernels.cuda_lib.build_dir()`` (``build/gfdm_tpu_torch/`` in a checkout),
under a name keyed by a hash of the source and flags. There is no NumPy
fallback: a failed build raises RuntimeError carrying the compiler's log.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "available",
    "sc16_to_planar",
    "planar_to_sc16",
    "bits_to_qpsk_planar",
    "qpsk_planar_to_bits",
    "StreamBuffer",
    "StreamBank",
    "FileIngest",
    "UdpIngest",
    "SC16_SCALE",
]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "gfdm_host.cpp"
# native/Makefile's CXXFLAGS, then -shared
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")
SC16_SCALE = float(2**15 - 1)

_lib = None
_lock = threading.Lock()


def _build(source: Path = SOURCE, cxx: str = "g++", out_dir: Path | None = None) -> Path:
    """Compile ``source`` into a shared library under ``out_dir`` (default
    ``cuda_lib.build_dir()``), unless a library of the same hash is there.

    Concurrent builders (test workers) each write a temporary name and
    ``os.replace`` it, so a reader never sees a partial file.
    """
    from ..kernels.cuda_lib import build_dir

    out_dir = Path(build_dir() if out_dir is None else out_dir)
    try:
        src = Path(source).read_bytes()
    except OSError as exc:
        raise RuntimeError(f"native host library: cannot read {source}: {exc}") from exc
    digest = hashlib.sha256(" ".join((cxx,) + CXX_FLAGS).encode() + src).hexdigest()[:16]
    lib_path = out_dir / f"libgfdm_host_{digest}.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = Path(tmp) / lib_path.name
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp_lib), str(source)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as exc:
            raise RuntimeError(f"native host library: cannot run {cxx}: {exc}") from exc
        if proc.returncode != 0:
            raise RuntimeError(
                f"native host library: {' '.join(cmd)} failed "
                f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp_lib, lib_path)
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, f32p, i16p, u8p, vp = (
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_void_p,
    )
    sigs = {
        "gfdm_sc16_to_planar": (None, [i16p, f32p, f32p, i64, ctypes.c_float]),
        "gfdm_planar_to_sc16": (None, [f32p, f32p, i16p, i64, ctypes.c_float]),
        "gfdm_bits_to_qpsk_planar": (None, [u8p, f32p, f32p, i64]),
        "gfdm_qpsk_planar_to_bits": (None, [f32p, f32p, u8p, i64]),
        "gfdm_stream_create": (vp, [i64, i64, i64]),
        "gfdm_stream_destroy": (None, [vp]),
        "gfdm_stream_push": (i64, [vp, f32p, f32p, i64]),
        "gfdm_stream_push_sc16": (i64, [vp, i16p, i64, ctypes.c_float]),
        "gfdm_stream_available_chunks": (i64, [vp]),
        "gfdm_stream_dropped": (i64, [vp]),
        "gfdm_stream_pull": (i64, [vp, f32p, i64, ctypes.POINTER(i64)]),
        "gfdm_bank_create": (vp, [i64, i64, i64, i64]),
        "gfdm_bank_destroy": (None, [vp]),
        "gfdm_bank_push": (i64, [vp, i64, f32p, f32p, i64]),
        "gfdm_bank_push_sc16": (i64, [vp, i64, i16p, i64, ctypes.c_float]),
        "gfdm_bank_available_chunks": (i64, [vp]),
        "gfdm_bank_dropped": (i64, [vp]),
        "gfdm_bank_pull": (i64, [vp, f32p, i64, ctypes.POINTER(i64)]),
        "gfdm_ingest_start_sc16": (vp, [ctypes.c_char_p, vp, ctypes.c_float, i64]),
        "gfdm_ingest_start_udp": (vp, [ctypes.c_uint16, vp, ctypes.c_float, i64]),
        "gfdm_ingest_request_stop": (None, [vp]),
        "gfdm_ingest_poll": (i64, [vp]),
        "gfdm_ingest_finish": (i64, [vp]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _load() -> ctypes.CDLL:
    """The host library, built on first call; raises RuntimeError if the
    build fails."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(_build())))
        return _lib


def available() -> bool:
    """True once the library has loaded (building it on first call); a
    failed build raises instead of returning False."""
    return _load() is not None


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i16(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _planar(planar) -> np.ndarray:
    planar = np.ascontiguousarray(planar, dtype=np.float32)
    if planar.ndim != 2 or planar.shape[0] != 2:
        raise ValueError(f"expected (2, n) planar samples, got shape {planar.shape}")
    return planar


def _sc16(raw) -> np.ndarray:
    raw = np.ascontiguousarray(raw, dtype=np.int16).reshape(-1)
    if raw.size % 2:
        raise ValueError(f"interleaved sc16 needs an even count of int16, got {raw.size}")
    return raw


def sc16_to_planar(raw: np.ndarray, scale: float = SC16_SCALE) -> np.ndarray:
    """Interleaved int16 IQ -> (2, n) planar float32 (divided by ``scale``)."""
    raw = _sc16(raw)
    n = raw.size // 2
    out = np.empty((2, n), dtype=np.float32)
    _load().gfdm_sc16_to_planar(_i16(raw), _f32(out[0]), _f32(out[1]), n, float(scale))
    return out


def planar_to_sc16(planar: np.ndarray, scale: float = SC16_SCALE) -> np.ndarray:
    """(2, n) planar float32 -> interleaved int16 IQ (times ``scale``,
    rounded to nearest, saturated)."""
    planar = _planar(planar)
    n = planar.shape[-1]
    out = np.empty(2 * n, dtype=np.int16)
    _load().gfdm_planar_to_sc16(_f32(planar[0]), _f32(planar[1]), _i16(out), n,
                                float(scale))
    return out


def bits_to_qpsk_planar(bits: np.ndarray) -> np.ndarray:
    """(n, 2) 0/1 bits -> (2, n) planar unit-energy QPSK (bit 1 -> -1/sqrt 2)."""
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    if bits.ndim != 2 or bits.shape[1] != 2:
        raise ValueError(f"expected (n, 2) bits, got shape {bits.shape}")
    n = bits.shape[0]
    out = np.empty((2, n), dtype=np.float32)
    _load().gfdm_bits_to_qpsk_planar(_u8(bits), _f32(out[0]), _f32(out[1]), n)
    return out


def qpsk_planar_to_bits(planar: np.ndarray) -> np.ndarray:
    """(2, n) planar symbols -> (n, 2) hard bits (1 where a plane is < 0)."""
    planar = _planar(planar)
    n = planar.shape[-1]
    out = np.empty((n, 2), dtype=np.uint8)
    _load().gfdm_qpsk_planar_to_bits(_f32(planar[0]), _f32(planar[1]), _u8(out), n)
    return out


class StreamBuffer:
    """Native SPSC ring framing an IQ stream into halo-extended chunks.

    ``push`` planar samples from the producer (a radio thread, an ingest
    thread, the transmit service); ``pull`` returns batches of shape
    (n_chunks, 2, chunk_len + halo) for the batched receiver, each chunk
    advancing by ``chunk_len``. ``capacity`` is in samples (rounded up to a
    multiple of ``chunk_len``); overflow drops the oldest whole chunks.
    """

    def __init__(self, capacity: int, chunk_len: int, halo: int):
        self._lib = _load()
        self.chunk_len = int(chunk_len)
        self.halo = int(halo)
        self._h = ctypes.c_void_p(
            self._lib.gfdm_stream_create(int(capacity), self.chunk_len, self.halo)
        )

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.gfdm_stream_destroy(h)
            self._h = None

    def push(self, planar: np.ndarray) -> int:
        """Push (2, n) planar samples; returns the total samples dropped."""
        planar = _planar(planar)
        return int(self._lib.gfdm_stream_push(
            self._h, _f32(planar[0]), _f32(planar[1]), planar.shape[-1]))

    def push_sc16(self, raw: np.ndarray, scale: float = SC16_SCALE) -> int:
        """Push interleaved int16 IQ, converted natively in the same pass."""
        raw = _sc16(raw)
        return int(self._lib.gfdm_stream_push_sc16(self._h, _i16(raw), raw.size // 2,
                                                   float(scale)))

    @property
    def available_chunks(self) -> int:
        return int(self._lib.gfdm_stream_available_chunks(self._h))

    @property
    def dropped(self) -> int:
        """Cumulative samples dropped to ring overflow since creation."""
        return int(self._lib.gfdm_stream_dropped(self._h))

    def pull(self, max_chunks: int):
        """-> ((n, 2, chunk_len + halo) float32, absolute sample offset of
        the first chunk)."""
        ext = self.chunk_len + self.halo
        out = np.empty((int(max_chunks), 2, ext), dtype=np.float32)
        base = ctypes.c_int64(0)
        n = int(self._lib.gfdm_stream_pull(self._h, _f32(out), int(max_chunks),
                                           ctypes.byref(base)))
        return out[:n], int(base.value)


class StreamBank:
    """A bank of per-channel rings with time-aligned multi-channel pulls.

    Each channel (antenna port) pushes on its own; ``pull`` returns (n,
    n_channels, 2, chunk_len + halo) batches whose chunks are
    sample-aligned across channels (a laggard is realigned, counted as
    drops).
    """

    def __init__(self, n_channels: int, capacity: int, chunk_len: int, halo: int):
        self._lib = _load()
        self.n_channels = int(n_channels)
        self.chunk_len = int(chunk_len)
        self.halo = int(halo)
        self._h = ctypes.c_void_p(self._lib.gfdm_bank_create(
            self.n_channels, int(capacity), self.chunk_len, self.halo))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.gfdm_bank_destroy(h)
            self._h = None

    def _channel(self, channel: int) -> int:
        if not 0 <= int(channel) < self.n_channels:
            raise ValueError(f"channel {channel} out of range for {self.n_channels}")
        return int(channel)

    def push(self, channel: int, planar: np.ndarray) -> int:
        planar = _planar(planar)
        return int(self._lib.gfdm_bank_push(
            self._h, self._channel(channel), _f32(planar[0]), _f32(planar[1]),
            planar.shape[-1]))

    def push_sc16(self, channel: int, raw: np.ndarray, scale: float = SC16_SCALE) -> int:
        raw = _sc16(raw)
        return int(self._lib.gfdm_bank_push_sc16(
            self._h, self._channel(channel), _i16(raw), raw.size // 2, float(scale)))

    @property
    def available_chunks(self) -> int:
        return int(self._lib.gfdm_bank_available_chunks(self._h))

    @property
    def dropped(self) -> int:
        """Cumulative samples dropped across all channels (overflow + realign)."""
        return int(self._lib.gfdm_bank_dropped(self._h))

    def pull(self, max_chunks: int):
        """-> ((n, n_channels, 2, chunk_len + halo) float32, sample offset)."""
        ext = self.chunk_len + self.halo
        out = np.empty((int(max_chunks), self.n_channels, 2, ext), dtype=np.float32)
        base = ctypes.c_int64(0)
        n = int(self._lib.gfdm_bank_pull(self._h, _f32(out), int(max_chunks),
                                         ctypes.byref(base)))
        return out[:n], int(base.value)


class _Ingest:
    """A native reader thread pushing into a StreamBuffer (kept alive here)."""

    _lib: ctypes.CDLL
    _h: ctypes.c_void_p | None
    _stream: StreamBuffer

    def poll(self) -> int:
        """-1 while the thread runs, else the total samples it ingested."""
        if self._h is None:
            raise RuntimeError("ingest already finished")
        return int(self._lib.gfdm_ingest_poll(self._h))

    @property
    def running(self) -> bool:
        return self._h is not None and self.poll() < 0

    def finish(self) -> int:
        """Join the thread and free it; returns the total samples ingested."""
        if self._h is None:
            return 0
        n = int(self._lib.gfdm_ingest_finish(self._h))
        self._h = None
        return n


class FileIngest(_Ingest):
    """Background-thread sc16 file reader feeding a StreamBuffer, with no
    Python in the loop (the UHD recv thread / io_uring reader role)."""

    def __init__(self, path: str, stream: StreamBuffer,
                 scale: float = SC16_SCALE, block_samples: int = 65536):
        self._lib = _load()
        self._stream = stream
        self._h = ctypes.c_void_p(self._lib.gfdm_ingest_start_sc16(
            os.fsencode(path), stream._h, float(scale), int(block_samples)))


class UdpIngest(_Ingest):
    """Background-thread UDP sc16 receiver feeding a StreamBuffer.

    The NIC-ingest analogue of a UHD / VITA-49 recv thread: interleaved sc16
    datagrams sent to 127.0.0.1:``port`` are converted and pushed into the
    ring with no Python in the loop. A zero-length datagram ends the stream;
    :meth:`stop` also ends the loop (seen within ~100 ms). The socket is
    bound before the constructor returns; a failed bind raises OSError.
    Datagrams shorter than one sample are probes and are dropped.
    """

    def __init__(self, port: int, stream: StreamBuffer,
                 scale: float = SC16_SCALE, max_datagram_bytes: int = 65536):
        self._lib = _load()
        self._stream = stream
        self.port = int(port)
        h = self._lib.gfdm_ingest_start_udp(self.port, stream._h, float(scale),
                                            int(max_datagram_bytes))
        if not h:
            self._h = None
            raise OSError(f"could not bind udp:{self.port}")
        self._h = ctypes.c_void_p(h)

    def stop(self) -> None:
        """Ask the receive loop to exit."""
        if self._h is not None:
            self._lib.gfdm_ingest_request_stop(self._h)
