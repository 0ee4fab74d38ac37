"""Receiver chain composite on complex tensors (the port of
``gfdm_tpu.runtime.receiver``).

Mirrors the reference's hierarchical receiver
(examples/hier_gfdm_receiver_tagged.grc: remove_prefix -> channel_estimator
-> advanced_receiver -> resource_demapper) plus the burst acquisition front
end (sync + extract_burst). Per-burst metrics (SNR, CNRs, channel estimate,
detection metadata) are returned beside the symbols, the functional
analogue of the reference's stream tags
(gr-gfdm/lib/channel_estimator_cc_impl.cc:99-114). A NumPy input goes to
``device``: the card unless the caller passes ``device="cpu"``; a tensor
stays where it is unless ``device`` names another.
"""
from __future__ import annotations

from ..config import GfdmConfig
from ..ops import burst as burst_ops
from ..ops import estimation
from ..ops import rx as rx_ops
from ..ops import sync as sync_ops
from ..ops._complex import DEFAULT_DTYPE, as_complex

__all__ = ["receive_bursts", "receive_stream"]


def receive_bursts(
    cfg: GfdmConfig,
    bursts,
    ic_iterations: int = 2,
    equalize: bool = True,
    constellation=rx_ops.qpsk_constellation,
    phase_compensation: bool = False,
    dtype=DEFAULT_DTYPE,
    device=None,
):
    """Demodulate framed bursts aligned at the full-preamble start.

    ``bursts``: (..., >= frame_len) with layout
      [cp | core preamble (2K) | cs | cp | payload (M*K) | cs].

    Returns a dict with payload symbols and per-burst metrics.
    """
    bursts = as_complex(bursts, dtype, device, "receive_bursts")
    K = cfg.subcarriers
    rx_pre = bursts[..., cfg.cp_len : cfg.cp_len + 2 * K]
    channel = estimation.estimate_frame(cfg, rx_pre, dtype=dtype)
    snr_lin, cnrs = estimation.estimate_snr(cfg, rx_pre, dtype=dtype)

    start = cfg.preamble_len + cfg.cp_len
    frame = bursts[..., start : start + cfg.block_len]
    symbols = rx_ops.ic_receiver(
        cfg,
        frame,
        channel_fd=channel if equalize else None,
        ic_iterations=ic_iterations,
        constellation=constellation,
        phase_compensation=phase_compensation,
        dtype=dtype,
    )
    return {
        "data": rx_ops.demap_resources(cfg, symbols),
        "symbols": symbols,
        "channel": channel,
        "snr_lin": snr_lin,
        "cnrs": cnrs,
    }


def receive_stream(
    cfg: GfdmConfig,
    stream,
    ic_iterations: int = 2,
    equalize: bool = True,
    correct_cfo: bool = True,
    constellation=rx_ops.qpsk_constellation,
    dtype=DEFAULT_DTYPE,
    device=None,
):
    """Full receiver from raw IQ chunks: sync -> extract -> demodulate.

    ``stream``: (..., chunk_len) with one burst per chunk (the steady-state
    layout; see runtime.stream for the halo chunking of continuous
    streams). ``constellation`` sets the IC decision points (e.g.
    ops.rx.constellation_points('qam16')).
    """
    stream = as_complex(stream, dtype, device, "receive_stream")
    detection = sync_ops.detect_bursts(cfg, stream, dtype=dtype)
    bursts = burst_ops.extract_bursts(cfg, stream, detection, correct_cfo=correct_cfo,
                                      dtype=dtype)
    out = receive_bursts(cfg, bursts, ic_iterations=ic_iterations, equalize=equalize,
                         constellation=constellation, dtype=dtype)
    out["detection"] = detection
    return out
