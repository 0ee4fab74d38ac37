"""GNU-Radio-style block API: name-for-name parity with the reference (the
port of ``gfdm_tpu.blocks``).

Users of gr-gfdm compose flowgraphs from blocks; this module offers the same
block names with the same parameters, each a thin callable over the port's
complex-dtype ops (one call processes a whole burst batch instead of a
sample stream). Each block takes ``device`` at construction: a NumPy input
goes there, the card unless the caller passes ``device="cpu"`` (without a
card and without ``device`` a call raises); a tensor stays on its own
device unless ``device`` names another.

Reference blocks covered:
  transmitter_cc, simple_modulator_cc, simple_receiver_cc,
  advanced_receiver_sb_cc, cyclic_prefixer_cc, remove_prefix_cc,
  extract_burst_cc, channel_estimator_cc, resource_mapper_cc,
  resource_demapper_cc, short_burst_shaper, modulator_cc (legacy).
"""
from __future__ import annotations

from .config import GfdmConfig
from .ops import burst as _burst
from .ops import estimation as _est
from .ops import legacy as _legacy
from .ops import rx as _rx
from .ops import sync as _sync
from .ops import tx as _tx
from .ops._complex import DEFAULT_DTYPE, as_complex
from .runtime.transmitter import shape_bursts as _shape

__all__ = [
    "transmitter_cc",
    "simple_modulator_cc",
    "simple_receiver_cc",
    "advanced_receiver_sb_cc",
    "cyclic_prefixer_cc",
    "remove_prefix_cc",
    "extract_burst_cc",
    "channel_estimator_cc",
    "resource_mapper_cc",
    "resource_demapper_cc",
    "short_burst_shaper",
    "modulator_cc",
    "preamble_generator",
]


def preamble_generator(nsubcarrier: int, filter_alpha: float, sync_fft_len: int,
                       seed: int | None = None, cp_len: int = 0,
                       ramp_len: int = 0):
    """Standalone sync-preamble source (GRC variable block).

    Mirrors the reference's `gfdm.preamble_generator(nsubcarrier,
    filter_alpha, sync_fft_len)` variable
    (gr-gfdm/grc/gfdm_preamble_generator.block.yml:23), whose semantics
    follow the pygfdm preamble machinery it wrapped
    (gr-gfdm/python/pygfdm/preamble.py:91-132): a two-half repeating
    Schmidl&Cox-style preamble of ``sync_fft_len`` samples with
    ``nsubcarrier`` active subcarriers. NumPy, no device.

    Returns ``(windowed_preamble, core_preamble)`` as complex arrays.
    """
    from .ref.mapping import subcarrier_map
    from .ref.preamble import mapped_preamble

    subcarriers = sync_fft_len // 2
    if not (0 < nsubcarrier <= subcarriers):
        raise ValueError(
            f"nsubcarrier must be in (0, sync_fft_len/2 = {subcarriers}]"
        )
    smap = subcarrier_map(subcarriers, nsubcarrier, dc_free=False)
    return mapped_preamble(
        seed, "rrc", filter_alpha, nsubcarrier, subcarriers, smap,
        overlap=2, cp_len=cp_len, ramp_len=ramp_len, use_zadoff_chu=True,
    )


class _Block:
    def __init__(self, cfg: GfdmConfig, device=None):
        self.cfg = cfg
        self.device = device

    def _in(self, x):
        return as_complex(x, DEFAULT_DTYPE, self.device, type(self).__name__)

    def __repr__(self):
        return f"{type(self).__name__}(M={self.cfg.timeslots}, K={self.cfg.subcarriers})"


class transmitter_cc(_Block):
    """Full Tx: mapper -> modulator -> prefixer (+ preamble), one output per
    cyclic shift (gr-gfdm/lib/transmitter_cc_impl.cc:130-195)."""

    def __call__(self, data):
        return _tx.transmit(self.cfg, data, device=self.device)


class simple_modulator_cc(_Block):
    """Core GFDM modulator on subcarrier-major symbol frames
    (gr-gfdm/lib/simple_modulator_cc_impl.cc:30-80)."""

    def __call__(self, grid_frames):
        return _tx.modulate(self.cfg, grid_frames, device=self.device)


class simple_receiver_cc(_Block):
    """Matched-filter demodulator
    (gr-gfdm/lib/simple_receiver_cc_impl.cc:62-80)."""

    def __call__(self, frames):
        return _rx.demodulate(self.cfg, frames, device=self.device)


class advanced_receiver_sb_cc(_Block):
    """IC receiver; pass ``channel`` (2nd 'port') to enable the equalize path
    (gr-gfdm/lib/advanced_receiver_sb_cc_impl.cc:64-120)."""

    def __init__(self, cfg: GfdmConfig, ic_iterations: int = 2,
                 constellation=_rx.qpsk_constellation, do_phase_compensation=False,
                 device=None):
        super().__init__(cfg, device)
        self.ic_iterations = ic_iterations
        self.constellation = constellation
        self.do_phase_compensation = bool(do_phase_compensation)

    def set_ic(self, n: int):
        self.ic_iterations = int(n)

    def get_ic(self) -> int:
        return self.ic_iterations

    def __call__(self, frames, channel=None):
        return _rx.ic_receiver(
            self.cfg,
            frames,
            channel_fd=channel,
            ic_iterations=self.ic_iterations,
            constellation=self.constellation,
            phase_compensation=self.do_phase_compensation,
            device=self.device,
        )


class cyclic_prefixer_cc(_Block):
    """CP/CS + window insertion
    (gr-gfdm/lib/cyclic_prefixer_cc_impl.cc:56-102)."""

    def __init__(self, cfg: GfdmConfig, cyclic_shift: int = 0, device=None):
        super().__init__(cfg, device)
        self.cyclic_shift = cyclic_shift

    def __call__(self, core_frames):
        return _tx.add_cyclic_prefix(self.cfg, core_frames, self.cyclic_shift,
                                     device=self.device)


class remove_prefix_cc(_Block):
    """Offset slice out of tagged frames
    (gr-gfdm/lib/remove_prefix_cc_impl.cc:84-115)."""

    def __init__(self, cfg: GfdmConfig, offset: int | None = None,
                 block_len: int | None = None, device=None):
        super().__init__(cfg, device)
        self.offset = cfg.cp_len if offset is None else offset
        self.block_len = cfg.block_len if block_len is None else block_len

    def __call__(self, framed):
        return _burst.remove_prefix(self._in(framed), self.offset, self.block_len)


class extract_burst_cc(_Block):
    """Detector-driven burst extraction with normalization + CFO correction
    (gr-gfdm/lib/extract_burst_cc_impl.cc:117-241). The GR tag dict is
    replaced by the detection metadata from :meth:`sync` or
    :func:`gfdm_tpu_torch.ops.sync.detect_bursts`."""

    def __init__(self, cfg: GfdmConfig, burst_len: int | None = None,
                 tag_backoff: int | None = None, activate_cfo_correction=True,
                 device=None):
        super().__init__(cfg, device)
        self.burst_len = burst_len
        self.tag_backoff = tag_backoff
        self.activate_cfo_correction = bool(activate_cfo_correction)

    def activate_cfo_compensation(self, on: bool):
        self.activate_cfo_correction = bool(on)

    def __call__(self, stream, detection):
        return _burst.extract_bursts(
            self.cfg, stream, detection,
            burst_len=self.burst_len, backoff=self.tag_backoff,
            correct_cfo=self.activate_cfo_correction, device=self.device,
        )

    def sync(self, stream, search_limit=None):
        """Built-in detector (replaces the external XFDMSync chain)."""
        return _sync.detect_bursts(self.cfg, stream, search_limit=search_limit,
                                   device=self.device)


class channel_estimator_cc(_Block):
    """Preamble -> full-frame channel estimate + SNR/CNR metrics
    (gr-gfdm/lib/channel_estimator_cc_impl.cc:59-114)."""

    def __call__(self, rx_preambles):
        rx_preambles = self._in(rx_preambles)
        est = _est.estimate_frame(self.cfg, rx_preambles)
        snr_lin, cnrs = _est.estimate_snr(self.cfg, rx_preambles)
        return est, {"snr_lin": snr_lin, "cnr": cnrs}


class resource_mapper_cc(_Block):
    def __call__(self, data):
        return _tx.map_resources(self.cfg, data, device=self.device)


class resource_demapper_cc(_Block):
    def __call__(self, frames):
        return _rx.demap_resources(self.cfg, self._in(frames))


class short_burst_shaper(_Block):
    """Zero padding + complex scaling (+ timed-Tx scheduling via
    gfdm_tpu_torch.runtime.timing.BurstScheduler)
    (gr-gfdm/lib/short_burst_shaper_impl.cc:161-233)."""

    def __init__(self, cfg: GfdmConfig, pre_padding: int | None = None,
                 post_padding: int | None = None, scale=1.0, device=None):
        super().__init__(cfg, device)
        self.pre_padding = pre_padding
        self.post_padding = post_padding
        self.scale = scale

    def __call__(self, bursts):
        return _shape(self.cfg, bursts, scale=self.scale,
                      pre=self.pre_padding, post=self.post_padding, device=self.device)


class modulator_cc(_Block):
    """Legacy oversampled centered-spectrum modulator
    (gr-gfdm/lib/modulator_cc_impl.cc:115-199)."""

    def __init__(self, cfg: GfdmConfig, fft_len: int | None = None, device=None):
        super().__init__(cfg, device)
        self.fft_len = cfg.block_len if fft_len is None else int(fft_len)
        if self.fft_len < cfg.block_len:
            raise ValueError("fft_len must be >= timeslots * subcarriers")

    def __call__(self, grid_frames):
        return _legacy.modulate_oversampled(self.cfg, grid_frames, self.fft_len,
                                            device=self.device)
