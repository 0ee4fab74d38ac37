"""Persistent streaming transmit service: the Tx mirror of StreamingReceiver.

The port of ``gfdm_tpu.runtime.transmit_service`` for one card. The
reference's transmit direction is a free-running flowgraph: payload source
-> transmitter_cc -> short_burst_shaper (padding/scale + timed USRP bursts)
-> radio sink (gr-gfdm/examples/gfdm_ota_demo.grc). Here one batched Tx
step - the Tx kernel (``kernels.fused.tx_frame_fused``, csrc/tx.cu, one
launch a step) on the card, its plain version on the CPU - replaces the
scheduler threads, and the service assembles the timed burst train into a
continuous planar sample stream that any sink consumes. Burst timing comes
from runtime.timing.BurstScheduler, the cycle-grid quantization of the
reference's timed-Tx path (gr-gfdm/lib/short_burst_shaper_impl.cc:184-233).
:class:`UdpSink` sends the stream as sc16 datagrams, the wire format the
native ``UdpIngest`` receives: StreamingTransmitter -> UdpSink -> UdpIngest
-> StreamBuffer -> StreamingReceiver is the modem over a real socket.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import GfdmConfig
from ..device import resolve_device

__all__ = ["TxStats", "StreamingTransmitter", "UdpSink"]


class UdpSink:
    """Datagram sc16 IQ sender: the uhd_usrp_sink analogue over UDP.

    Accepts (2, n) planar float32 sample blocks through ``push`` (the
    StreamingTransmitter sink contract), converts them to interleaved sc16
    with the native converter (times ``gain``) and sends them as datagrams
    of at most ``samples_per_datagram`` samples to ``host:port``, the format
    ``native.UdpIngest`` ingests (the software analogue of the reference's
    USRP OTA loop, gr-gfdm/examples/gfdm_ota_demo.grc). ``close()`` sends the
    zero-length end-of-stream datagram UdpIngest understands.
    """

    def __init__(self, port: int, host: str = "127.0.0.1",
                 samples_per_datagram: int = 4096, gain: float = 1.0):
        import socket

        from ..native import SC16_SCALE

        self.addr = (host, int(port))
        self.samples_per_datagram = int(samples_per_datagram)
        self.gain = float(gain)
        self.scale = SC16_SCALE
        self.samples_sent = 0
        self.datagrams_sent = 0
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def push(self, planar: np.ndarray) -> None:
        """Send a (2, n) planar float32 block as sc16 datagrams."""
        from ..native import planar_to_sc16

        if self._sock is None:
            raise RuntimeError("UdpSink is closed")
        planar = np.ascontiguousarray(planar, np.float32)
        if self.gain != 1.0:
            planar = planar * np.float32(self.gain)
        raw = planar_to_sc16(planar, self.scale)
        step = 2 * self.samples_per_datagram
        for i in range(0, raw.size, step):
            self._sock.sendto(raw[i : i + step].tobytes(), self.addr)
            self.datagrams_sent += 1
        self.samples_sent += planar.shape[-1]

    def close(self, end_of_stream: bool = True) -> None:
        """Send the end-of-stream datagram (unless told not to) and close."""
        if self._sock is not None:
            try:
                if end_of_stream:
                    self._sock.sendto(b"", self.addr)
            finally:
                self._sock.close()
                self._sock = None


@dataclass
class TxStats:
    batches: int = 0
    bursts: int = 0
    samples: int = 0


@dataclass
class StreamingTransmitter:
    """Batched burst transmitter emitting a timed continuous sample stream.

    One ``step`` modulates a payload batch with one Tx-kernel launch (map ->
    modulate -> CP/window -> preamble); ``serve`` pulls payload batches
    from a source, places each burst on the ``cycle_samples`` grid (one
    burst per cycle, zero-filled gaps - the short_burst_shaper's padding
    contract) and hands the assembled stream to the sink together with
    per-burst ``tx_time`` stamps. ``device`` defaults to the current CUDA
    device; without one the constructor raises. Pass ``device="cpu"`` to
    run the Tx kernel's plain version on the CPU.
    """

    cfg: GfdmConfig
    batch_bursts: int = 64
    scale: float = 1.0
    cyclic_shift_index: int = 0
    sample_rate: float = 3.125e6
    # grid period between burst starts, in samples; must hold a whole burst.
    # default: the padded power-of-two frame (configurator padding contract)
    cycle_samples: int | None = None
    timing_advance_secs: float = 0.0
    device: object = None
    stats: TxStats = field(default_factory=TxStats)

    def __post_init__(self):
        from .timing import BurstScheduler

        if self.cycle_samples is None:
            self.cycle_samples = self.cfg.padded_frame_len
        if self.cycle_samples < self.cfg.frame_len:
            raise ValueError(
                f"cycle_samples {self.cycle_samples} cannot hold a "
                f"{self.cfg.frame_len}-sample burst"
            )
        if not 0 <= self.cyclic_shift_index < len(self.cfg.cyclic_shifts):
            raise ValueError(
                f"cyclic_shift_index {self.cyclic_shift_index} out of range "
                f"for {len(self.cfg.cyclic_shifts)} configured shifts"
            )
        self.device = resolve_device(self.device, "StreamingTransmitter")
        self.scheduler = BurstScheduler(
            cycle_interval_secs=self.cycle_samples / self.sample_rate,
            timing_advance_secs=self.timing_advance_secs,
        )
        self._next_slot = 0  # absolute sample index of the next burst start

    def _tx(self, payloads: torch.Tensor) -> torch.Tensor:
        """(B, 2, n_data) float32 payloads on the device -> (B, 2, frame_len)
        bursts times ``scale``, without a host sync."""
        from ..kernels.fused import tx_frame_fused

        return tx_frame_fused(self.cfg, payloads, int(self.cyclic_shift_index)) * self.scale

    def step(self, payloads: np.ndarray) -> np.ndarray:
        """(B, 2, n_data) planar payload symbols -> (B, 2, frame_len)."""
        t = torch.from_numpy(np.ascontiguousarray(payloads, np.float32))
        return self._tx(t.to(self.device)).cpu().numpy()

    def _assemble(self, bursts: np.ndarray):
        """Place bursts on the cycle grid -> (2, n*cycle) stream + stamps."""
        n = bursts.shape[0]
        cyc = self.cycle_samples
        stream = np.zeros((2, n * cyc), np.float32)
        stamps = []
        for i in range(n):
            start = i * cyc
            stream[:, start : start + bursts.shape[-1]] = bursts[i]
            abs_start = self._next_slot + start
            stamps.append(
                (abs_start / self.sample_rate - self.timing_advance_secs, abs_start)
            )
        self._next_slot += n * cyc
        return stream, stamps

    def serve(self, source, sink, max_batches: int | None = None) -> TxStats:
        """Run the transmit loop until the source is exhausted.

        ``source``: callable returning a (B, 2, n_data) planar payload batch
        or None when done. ``sink``: callable receiving a dict with
        ``samples`` (2, T) float32 planar, ``tx_times`` [(secs, abs_sample)],
        and ``bursts`` (the modulated burst batch); an object with ``push``
        (a ring such as the native StreamBuffer) gets the planar stream.
        """
        push = getattr(sink, "push", None)

        def emit(out):
            if push is not None:
                push(out["samples"])
            else:
                sink(out)

        batches = 0
        while max_batches is None or batches < max_batches:
            payloads = source()
            if payloads is None:
                break
            bursts = self.step(payloads)
            stream, stamps = self._assemble(bursts)
            self.stats.batches += 1
            self.stats.bursts += bursts.shape[0]
            self.stats.samples += stream.shape[-1]
            emit({"samples": stream, "tx_times": stamps, "bursts": bursts})
            batches += 1
        return self.stats
