"""Streaming receive service: a persistent receive loop on one device.

The port of ``gfdm_tpu.runtime.service`` for one card. Radio front-ends or
file readers feed a ring of halo-extended chunks (the framework-free native
``StreamBuffer`` of the port's ``native`` fits: anything with ``.pull(n)``);
the service copies each batch to the device, runs detection, extraction,
two-stage CFO and the receiver, and hands payloads and metrics to a sink.
The GNU Radio analogue is the running flowgraph's scheduler loop
(gr-gfdm/examples/hier_gfdm_receiver_tagged.grc).

Host-device protocol: a batch goes host -> device through pinned memory
with ``non_blocking=True`` on the device's current stream; the step only
enqueues work (no ``.item()``, no Python branch on a tensor), so with
``pipeline_depth=2`` the next batch is copied and enqueued while the card
still runs the previous one. Only ``_fetch`` waits for the card.

``fec="conv"`` also soft-decodes every slot on the service's device (max-log
LLRs, deinterleave, radix Viterbi: ``_build_fec``) and returns its info
bits. The JAX package's device mesh, ``shard_map`` and VMEM block picker
have no counterpart on one card; ``sp_shards > 1`` waits for ROADMAP.md
Queue 1 item 10.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import GfdmConfig
from ..device import resolve_device
from .stream import _flatten_slots, _found_mask, receive_chunks_planar

__all__ = ["host_chunk_range", "ServiceStats", "StreamingReceiver"]


def host_chunk_range(total_chunks: int, n_hosts: int, host: int) -> range:
    """Contiguous chunk assignment for one host.

    Contiguity keeps every chunk's lookahead-halo neighbour on the same host
    except the single boundary chunk, whose halo the producer already
    delivered inside the extended chunk - so no inter-host sample exchange
    is needed at receive time.
    """
    per = (total_chunks + n_hosts - 1) // n_hosts
    lo = min(host * per, total_chunks)
    return range(lo, min(lo + per, total_chunks))


@dataclass
class ServiceStats:
    batches: int = 0
    chunks: int = 0
    bursts_found: int = 0
    samples: int = 0
    dropped_ring: int = 0
    snr_db_sum: float = 0.0

    @property
    def mean_snr_db(self) -> float:
        return self.snr_db_sum / max(self.bursts_found, 1)


@dataclass
class StreamingReceiver:
    """Persistent receive loop over halo-extended chunk batches on one device.

    One step receives ``batch_chunks`` chunks at a time; detection,
    extraction and demodulation are chunk-local. Feed it from a ring with
    ``.pull(n)`` (the native StreamBuffer/StreamBank), a file, or any
    callable source. ``engine="fused"`` runs the CUDA receiver kernel
    (kernels/fused.receive_bursts_fused) after detection; ``"xla"`` keeps
    the whole step as torch ops (runtime/stream.receive_chunks_planar).
    ``device`` defaults to the current CUDA device; without one the
    constructor raises. Pass ``device="cpu"`` to run on the CPU, where the
    kernels' wrappers run their plain versions.
    """

    cfg: GfdmConfig
    chunk_len: int = 2048
    batch_chunks: int = 8
    # super-batching ceiling: serve() pulls up to this many chunks per
    # dispatch when the ring has backlog, amortizing the fixed per-dispatch
    # cost. Batch shapes are padded to a geometric ladder batch_chunks * 2^j.
    # None -> batch_chunks (no super-batching).
    max_batch_chunks: int | None = None
    ic_iterations: int = 2
    max_bursts_per_chunk: int = 1
    # detection decision: CFAR threshold derived from false_alarm_prob
    # (ops.sync.detection_valid); min_strength overrides it with a raw
    # gated-peak floor
    min_strength: float | None = None
    false_alarm_prob: float = 1e-5
    equalizer: str = "zf"  # "zf" | "mmse" | "mmse_cnr"
    constellation: str = "qpsk"  # "qpsk" | "qam16" | "qam64"
    # fec="conv": the step also soft-decodes each slot on the service's
    # device - planar max-log LLRs from the per-slot SNR estimate,
    # deinterleave, radix Viterbi - and returns its info bits ("bits"); the
    # framing is cli.payload_to_symbols(fec="conv")'s, so a sink can
    # pack_bits + check_crc32 directly
    fec: str = "none"  # "none" | "conv"
    # receiver of the xla engine: "dense" operators or the factorized
    # "fast" stages; the fused engine runs the dense receiver kernel
    method: str = "dense"
    # two-stage CFO: refine the coarse preamble estimate with the payload
    # block's N-lag CP correlation after extraction
    refine_cfo: bool = True
    # detection and extraction dtype; bfloat16 halves the front end's
    # memory traffic at ~6e-4 absolute CFO quantization (the JAX package's
    # priced budget, tests/test_detection.py::test_bf16_cfo_budget_is_priced)
    dtype_name: str = "bfloat16"
    engine: str = "xla"  # "xla" | "fused" (CUDA receiver kernel)
    sp_shards: int = 1  # > 1 is ROADMAP.md Queue 1 item 10
    # serve() keeps up to this many dispatched batches in flight before
    # fetching: 2 (double buffering) overlaps the host copy and the next
    # batch's enqueue with the card's compute; 1 is the single-deep loop
    pipeline_depth: int = 2
    device: object = None
    stats: ServiceStats = field(default_factory=ServiceStats)

    def __post_init__(self):
        if self.batch_chunks < 1:
            raise ValueError(f"batch_chunks must be >= 1, got {self.batch_chunks}")
        if self.max_batch_chunks is not None and (
            self.max_batch_chunks < self.batch_chunks
        ):
            raise ValueError("max_batch_chunks must be >= batch_chunks")
        if int(self.sp_shards) > 1:
            raise NotImplementedError(
                f"sp_shards={self.sp_shards}: the sample-axis-sharded service "
                "is ROADMAP.md Queue 1 item 10"
            )
        if self.fec not in ("none", "conv"):
            raise ValueError(f"unknown fec {self.fec!r}")
        if self.engine not in ("xla", "fused"):
            raise ValueError(f"unknown engine {self.engine!r}")
        self.device = resolve_device(self.device, "StreamingReceiver")
        if self.fec == "conv":
            self._build_fec()
        self.halo = self.cfg.frame_len + self.cfg.cp_len
        self.ext = self.chunk_len + self.halo
        self._spc = max(1, self.max_bursts_per_chunk)  # slots per chunk
        if self.engine == "fused":
            from ..kernels.fused import _kernel_consts, _rx_options

            _rx_options(constellation=self.constellation, equalizer=self.equalizer)
            _kernel_consts(self.cfg, self.device)
            self._step = self._fused_step
        else:
            from ..ops.planar_pipeline import prepare

            prepare(self.cfg, "float32", self.device, method=self.method)
            self._step = self._xla_step

    def _build_fec(self):
        """Device-side soft decoder matching the CLI's conv framing.

        Per slot: planar max-log LLRs weighted by the estimated noise
        variance 1/max(snr_lin, 1e-6), deinterleave (the arithmetic
        golden-ratio permutation, inverted, as one index tensor built
        here), radix Viterbi -> n_info bits. One burst carries one
        zero-terminated rate-1/2 K=7 codeword (cli.payload_to_symbols).
        """
        from ..coding import info_bits_for_block, interleaver
        from ..ops.rx import constellation_points

        pts = constellation_points(self.constellation)
        n_bits = int(np.log2(pts.size)) * self.cfg.n_data_symbols
        if n_bits % 2:
            raise ValueError(
                f"fec='conv' needs an even bits-per-burst budget, got {n_bits}"
            )
        self.fec_info_bits = info_bits_for_block(n_bits)
        self._fec_points = pts
        self._fec_inv = torch.as_tensor(np.argsort(interleaver(n_bits)),
                                        device=self.device)

    def _fec_decode(self, data_pl: torch.Tensor, snr_lin: torch.Tensor) -> torch.Tensor:
        """(slots, 2, n_data) payload symbols and (slots,) SNRs -> (slots,
        n_info) uint8 info bits, on the service's device."""
        from ..coding import viterbi_decode
        from ..ops.softbits import maxlog_llrs_planar

        nv = 1.0 / torch.clamp_min(snr_lin, 1e-6)
        llrs = maxlog_llrs_planar(data_pl, self._fec_points, nv[..., None])
        llrs = llrs.reshape(llrs.shape[0], -1).index_select(1, self._fec_inv)
        return viterbi_decode(llrs, self.fec_info_bits)

    def _xla_step(self, chunks: torch.Tensor) -> dict:
        out = receive_chunks_planar(
            self.cfg, chunks, self.chunk_len,
            ic_iterations=self.ic_iterations,
            min_strength=self.min_strength,
            max_bursts_per_chunk=self.max_bursts_per_chunk,
            dtype_name="float32",
            detect_dtype_name=self.dtype_name,
            method=self.method,
            equalizer=self.equalizer,
            false_alarm_prob=self.false_alarm_prob,
            constellation=self.constellation,
            refine_cfo=self.refine_cfo,
        )
        if self.fec == "conv":
            out["bits"] = self._fec_decode(out["data"], out["snr_lin"])
        return out

    def _fused_step(self, chunks: torch.Tensor) -> dict:
        """Detection, extraction and two-stage CFO as torch ops (or the
        detection kernels, by DETECT_IMPL), then the CUDA receiver kernel."""
        from ..kernels import fused as fk
        from ..ops import planar_pipeline as pp

        cfg, chunk_len, k = self.cfg, self.chunk_len, self._spc
        if k <= 1:
            det = pp.detect_bursts_planar(cfg, chunks, search_limit=chunk_len,
                                          dtype_name=self.dtype_name)
            det = {kk: v for kk, v in det.items() if kk != "ac_metric"}
            bursts = pp.extract_bursts_planar(cfg, chunks, det,
                                              dtype_name=self.dtype_name)
        else:
            det_k = pp.detect_bursts_topk_planar(
                cfg, chunks, max_bursts=k, search_limit=chunk_len,
                dtype_name=self.dtype_name,
            )
            rep = chunks[:, None].expand((chunks.shape[0], k) + chunks.shape[1:])
            det = _flatten_slots(det_k)
            bursts = pp.extract_bursts_planar(
                cfg, rep.reshape((-1,) + chunks.shape[1:]), det,
                dtype_name=self.dtype_name,
            )
        if self.refine_cfo:
            bursts, _ = pp.refine_cfo_planar(cfg, bursts)
        out = fk.receive_bursts_fused(
            cfg, bursts.contiguous(), ic_iterations=self.ic_iterations,
            equalizer=self.equalizer, constellation=self.constellation,
        )
        out["detection"] = det
        out["found"] = _found_mask(det, chunk_len, self.min_strength,
                                   self.false_alarm_prob)
        if self.fec == "conv":
            out["bits"] = self._fec_decode(out["data"], out["snr_lin"])
        return out

    def _slot_offsets(self, n: int) -> np.ndarray:
        """Per-slot sample offset of each slot's chunk in the recording."""
        return np.repeat(np.arange(n) * self.chunk_len, self._spc)

    def _padded_batch(self, n: int) -> int:
        """Pad a batch size up the geometric shape ladder.

        Bounds the set of batch shapes (and so of cached allocations) to
        the ladder's length while wasting < 2x compute on partial batches.
        """
        size = self.batch_chunks
        while size < n:
            size *= 2
        return size

    def _dispatch(self, chunks: np.ndarray):
        """Copy one batch to the device and enqueue its step; returns
        (device outputs, n). Makes no host sync."""
        n = chunks.shape[0]
        size = self._padded_batch(n)
        cuda = self.device.type == "cuda"
        host = torch.empty((size,) + tuple(chunks.shape[1:]), dtype=torch.float32,
                           pin_memory=cuda)
        host_np = host.numpy()
        host_np[:n] = chunks
        host_np[n:] = 0.0
        t = host.to(self.device, non_blocking=True) if cuda else host
        return self._step(t), n

    def _fetch(self, out: dict, n: int, fetch: tuple = ()):
        """Fetch one dispatched batch to the host and account stats."""
        # slots are chunk-major; padded chunks land at the end and are trimmed
        slots = n * self._spc

        def host(t):
            return t.cpu().numpy()[:slots]

        got = {
            "data": host(out["data"]),
            "snr_lin": host(out["snr_lin"]),
            "found": host(out["found"]),
            "start": host(out["detection"]["start"].reshape(-1)),
            "cfo": host(out["detection"]["cfo"].reshape(-1)),
        }
        if "bits" in out:  # fec="conv": the device-decoded info bits a slot
            got["bits"] = host(out["bits"])
        for key in fetch:
            got[key] = host(out[key])
        self.stats.batches += 1
        self.stats.chunks += n
        self.stats.samples += n * self.chunk_len
        nf = int(got["found"].sum())
        self.stats.bursts_found += nf
        if nf:
            snr = np.maximum(got["snr_lin"][got["found"]], 1e-9)
            self.stats.snr_db_sum += float(np.sum(10.0 * np.log10(snr)))
        return got

    def step(self, chunks: np.ndarray, fetch: tuple = ()):
        """Receive one (n_chunks, 2, chunk_len + halo) batch -> host dict.

        Only payloads and detection metadata are fetched by default; pass
        ``fetch=("symbols", "channel", "cnrs")`` for diagnostics. Batches
        smaller than ``batch_chunks`` are zero-padded up to it, so size the
        call to ``batch_chunks`` when throughput matters.
        """
        out, n = self._dispatch(np.asarray(chunks))
        return self._fetch(out, n, fetch)

    def serve(self, source, sink, max_batches: int | None = None) -> ServiceStats:
        """Run the receive loop until the source is exhausted.

        ``source``: a ring with ``.pull(n) -> (chunks, base)`` (pulled in
        batches of up to max_batch_chunks when it has backlog), or a
        callable returning an (n, 2, ext) ndarray, or a (chunks, base)
        tuple, or None when exhausted. ``sink``: callable(dict) receiving
        each step's host-side outputs (payload symbols, found mask,
        detection metadata, base sample offset, absolute starts).

        ``max_batches`` bounds the dispatches made by this call. The loop is
        software-pipelined ``pipeline_depth`` batches deep: up to that many
        batches are enqueued on the card before the oldest one is fetched.
        Ring overflow is accounted per call: if the source exposes a
        cumulative ``dropped`` counter, its growth since the last
        observation is added to ``stats.dropped_ring``.
        """
        pull_chunks = max(self.batch_chunks, self.max_batch_chunks or 0)
        # drops before this serve() call aren't ours to account
        dropped_seen = int(source.dropped) if hasattr(source, "dropped") else None

        def account_drops():
            nonlocal dropped_seen
            if dropped_seen is None:
                return
            total = int(source.dropped)
            self.stats.dropped_ring += total - dropped_seen
            dropped_seen = total

        if hasattr(source, "pull"):
            def pull():
                chunks, base = source.pull(pull_chunks)
                account_drops()
                if chunks.shape[0] == 0:
                    return None
                return chunks, base
        else:
            def pull():
                got = source()
                if got is None:
                    return None
                return got if isinstance(got, tuple) else (got, -1)

        def emit(pending):
            out_dev, n, base = pending
            out = self._fetch(out_dev, n)
            out["base_offset"] = base
            # absolute sample index of each slot's detection in the recording
            out["start_abs"] = out["start"] + base + self._slot_offsets(n)
            sink(out)

        depth = max(1, int(self.pipeline_depth))
        pending: deque = deque()
        dispatched = 0
        while max_batches is None or dispatched < max_batches:
            got = pull()
            if got is None:
                break
            chunks, base = got
            out_dev, n = self._dispatch(np.asarray(chunks))
            dispatched += 1
            pending.append((out_dev, n, base))
            if len(pending) > depth:
                emit(pending.popleft())
        while pending:
            emit(pending.popleft())
        # drops that land after the final pull still belong to this call
        account_drops()
        return self.stats
