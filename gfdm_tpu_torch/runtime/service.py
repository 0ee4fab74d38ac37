"""Streaming receive service: a persistent receive loop over a device mesh.

The port of ``gfdm_tpu.runtime.service``. Radio front-ends or file readers
feed a ring of halo-extended chunks (the framework-free native
``StreamBuffer`` of the port's ``native`` fits: anything with ``.pull(n)``);
the service copies each batch to the devices of its ('dp', 'sp') mesh
(``parallel.mesh``), runs detection, extraction, two-stage CFO and the
receiver, and hands payloads and metrics to a sink. The GNU Radio analogue
is the running flowgraph's scheduler loop
(gr-gfdm/examples/hier_gfdm_receiver_tagged.grc).

Mesh: the batch splits over the 'dp' rows; with ``sp_shards > 1`` each
chunk's owned region splits into sp sub-chunks over a row's columns, each
extended by the next sub-chunk's head and the last by the chunk's lookahead
tail. Shards that share a device run as one step, so on one card (a
"virtual" mesh of ``cuda:0`` repeated) a batch is one step at full width.

Multi-process: chunk batches are assigned to processes in contiguous time
ranges (``host_chunk_range``), so steady-state reception needs no
collective; ``init_distributed`` joins a ``torch.distributed`` group for the
metrics' sum (``parallel.multihost``).

Host-device protocol: a batch goes host -> device through pinned memory
with ``non_blocking=True`` on the device's current stream; the step only
enqueues work (no ``.item()``, no Python branch on a tensor). ``serve()``
stages one batch ahead on a thread of its own: the pinned buffer and the
NumPy copy into it (``_stage``, host memory alone) of batch b + 1 run while
the loop's thread enqueues batch b and fetches the oldest batch in flight,
so the card computes under the next batch's copy. Every CUDA call stays on
the loop's thread and its current stream. Only ``_fetch`` waits for the
card: on an event recorded on the stream at its start, which covers every
batch enqueued before it, so each fetch drains the one stream and
``pipeline_depth=2`` overlaps no card work with the outputs' copy to the
host or the loop's own enqueue. Each phase of the loop is a span
(``utils.profiling.span``) whose host seconds add up in ``stats.host_s``:
``gfdm.service.pull`` (the source call), ``.stage`` (the pinned buffer and
the NumPy copy into it; on the stager's thread in ``serve()``),
``.stage.wait`` (the loop's thread waiting for a staged batch),
``.h2d`` (enqueueing the copy to the card),
``.step`` (the step's enqueue, with ``.detect``, ``.extract``,
``.refine_cfo``, ``.receive`` and ``.decode`` inside it; the decoder's
``gfdm.fec.llr`` (the max-log LLRs and the deinterleave), ``gfdm.fec.acs``
and ``gfdm.fec.traceback`` inside that),
``.fetch.wait``, ``.fetch.copy`` (the outputs' pageable copies),
``.account`` (the stats) and ``.sink``. Under ``torch.profiler``
(``utils.profiling.trace_to``) they are ranges on the card's timeline.

``fec="conv"`` also soft-decodes every slot on its device (max-log LLRs,
deinterleave, radix Viterbi: ``_build_fec``) and returns its info bits; the
coded bits it decodes add up in ``stats.coded_bits``. The JAX package's
VMEM block picker has no counterpart here.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import GfdmConfig
from ..device import move, resolve_device
from ..parallel.mesh import device_runs, make_mesh
from ..utils.profiling import span
from .stream import _flatten_slots, _found_mask

__all__ = ["init_distributed", "host_chunk_range", "ServiceStats", "StreamingReceiver"]


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Join a ``torch.distributed`` group for a multi-process deployment.

    Arguments fall back to torch's standard environment: ``MASTER_ADDR`` /
    ``MASTER_PORT`` (the coordinator ``host:port``), ``WORLD_SIZE`` and
    ``RANK``. Without an address it is a no-op returning whether a group of
    more than one process is active; an initialized group is left alone.
    The backend is gloo: the values summed across processes are host
    counts, and NCCL refuses two ranks on one card.
    """
    import os

    import torch.distributed as dist

    if not dist.is_initialized():
        if coordinator_address is None and "MASTER_ADDR" in os.environ:
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ.get('MASTER_PORT', '29500')}")
        if coordinator_address is None:
            return False
        if num_processes is None:
            num_processes = int(os.environ["WORLD_SIZE"])
        if process_id is None:
            process_id = int(os.environ["RANK"])
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    return dist.get_world_size() > 1


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
    # host seconds of each ``gfdm.service.*`` span of the loop, summed; a
    # timing, so two runs' stats compare equal without it
    host_s: dict = field(default_factory=dict, compare=False)
    # served batches whose staging had finished when the loop asked for
    # them; timing-dependent too
    staged_ahead: int = field(default=0, compare=False)
    # coded bits soft-decoded (fec="conv"): slots x coded bits a slot of
    # every enqueued step, padded slots included
    coded_bits: int = 0

    @property
    def mean_snr_db(self) -> float:
        return self.snr_db_sum / max(self.bursts_found, 1)


@dataclass
class StreamingReceiver:
    """Persistent receive loop over halo-extended chunk batches on a mesh.

    One step receives ``batch_chunks`` chunks at a time, the chunk axis
    split over the mesh's 'dp' rows; detection, extraction and
    demodulation are chunk-local. Feed it from a ring with
    ``.pull(n)`` (the native StreamBuffer/StreamBank), a file, or any
    callable source. ``engine="fused"`` runs the CUDA receiver kernel
    (kernels/fused.receive_bursts_fused) after detection; ``"xla"`` keeps
    the whole step as torch ops (ops/planar_pipeline.receive_bursts_planar).
    ``mesh`` (``parallel.make_mesh``) defaults to one over ``device``, or
    over every visible card when ``device`` is None, reshaped (-1, sp);
    ``device`` defaults to the mesh's first device, else the current CUDA
    device; without one the constructor raises. Pass ``device="cpu"`` to run
    on the CPU, where the kernels' wrappers run their plain versions.
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
    # sample-axis sharding: each chunk's owned region is split into
    # sp_shards sub-chunks laid over the mesh's 'sp' axis; each sub-chunk is
    # extended by the next one's head (a device-to-device copy where the
    # next shard lives on another device) and the last by the chunk's
    # lookahead tail. Requires the fused engine, one burst per sub-chunk,
    # chunk_len % sp_shards == 0 and sub-chunks no shorter than the halo.
    sp_shards: int = 1
    mesh: object = None
    # serve() keeps up to this many dispatched batches in flight before
    # fetching the oldest; 1 is the single-deep loop. A fetch waits for
    # every batch enqueued before it, so what the card's work overlaps is
    # the next batch's staging, one batch ahead at any depth
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
        sp = int(self.sp_shards)
        if self.mesh is None:  # the given device, else every visible card
            dev = resolve_device(self.device, "StreamingReceiver")
            devices = ([dev] if self.device is not None
                       else [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
            if len(devices) % sp:
                raise ValueError(f"{len(devices)} devices not divisible by sp_shards={sp}")
            self.mesh = make_mesh(devices, sp=sp)
        self.halo = self.cfg.frame_len + self.cfg.cp_len
        self.ext = self.chunk_len + self.halo
        if sp > 1:
            if self.engine != "fused":
                raise ValueError("sp_shards > 1 requires engine='fused'")
            if self.max_bursts_per_chunk > 1:
                raise ValueError("sp_shards > 1 supports one burst per sub-chunk")
            if self.mesh.shape["sp"] != sp:
                raise ValueError("mesh 'sp' axis must match sp_shards")
            if self.chunk_len % sp:
                raise ValueError("chunk_len must divide evenly into sp_shards")
            if self.chunk_len // sp < self.halo:
                raise ValueError(
                    f"sub-chunks ({self.chunk_len // sp}) shorter than the "
                    f"halo ({self.halo}); lower sp_shards or raise chunk_len"
                )
        if self.fec not in ("none", "conv"):
            raise ValueError(f"unknown fec {self.fec!r}")
        if self.engine not in ("xla", "fused"):
            raise ValueError(f"unknown engine {self.engine!r}")
        self.device = torch.device(self.device if self.device is not None
                                   else self.mesh.devices[0, 0])
        if self.fec == "conv":
            self._build_fec()
        self._sub = self.chunk_len // sp  # owned samples a shard
        # slots per chunk: sp sub-chunks x k detection picks
        self._spc = sp * max(1, self.max_bursts_per_chunk)
        self._plans: dict = {}
        from ..kernels.fused import _kernel_consts, _rx_options
        from ..ops.planar_pipeline import prepare

        if self.engine == "fused":
            _rx_options(constellation=self.constellation, equalizer=self.equalizer)
        for dev in self.mesh.distinct_devices():
            if self.engine == "fused":
                _kernel_consts(self.cfg, dev)
            else:
                prepare(self.cfg, "float32", dev, method=self.method)
        self._step = self._sp_step if sp > 1 else self._chunk_step

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

        with span("gfdm.fec.llr", self.stats.host_s):
            nv = 1.0 / torch.clamp_min(snr_lin, 1e-6)
            llrs = maxlog_llrs_planar(data_pl, self._fec_points, nv[..., None])
            llrs = llrs.reshape(llrs.shape[0], -1).index_select(
                1, move(self._fec_inv, llrs.device))
        self.stats.coded_bits += llrs.shape[0] * llrs.shape[1]
        return viterbi_decode(llrs, self.fec_info_bits)

    def _chunk_step(self, chunks: torch.Tensor, owned: int | None = None) -> dict:
        """Detection, extraction and two-stage CFO as torch ops (or the
        detection kernels, by DETECT_IMPL), then the receiver: the CUDA
        receiver kernel (``engine="fused"``) or torch ops (``"xla"``), and
        with ``fec`` the decoder. ``owned``: the samples each chunk owns
        (the detection's search limit and the found mask's ownership),
        chunk_len by default."""
        from ..kernels import fused as fk
        from ..ops import planar_pipeline as pp
        from ..ops.rx import constellation_points

        cfg, k = self.cfg, max(1, self.max_bursts_per_chunk)
        chunk_len = self.chunk_len if owned is None else owned
        host_s = self.stats.host_s
        with span("gfdm.service.detect", host_s):
            if k <= 1:
                det = pp.detect_bursts_planar(cfg, chunks, search_limit=chunk_len,
                                              dtype_name=self.dtype_name)
                det = {kk: v for kk, v in det.items() if kk != "ac_metric"}
                windows = chunks
            else:
                det = _flatten_slots(pp.detect_bursts_topk_planar(
                    cfg, chunks, max_bursts=k, search_limit=chunk_len,
                    dtype_name=self.dtype_name,
                ))
                rep = chunks[:, None].expand((chunks.shape[0], k) + chunks.shape[1:])
                windows = rep.reshape((-1,) + chunks.shape[1:])
            found = _found_mask(det, chunk_len, self.min_strength, self.false_alarm_prob)
        with span("gfdm.service.extract", host_s):
            bursts = pp.extract_bursts_planar(cfg, windows, det, dtype_name=self.dtype_name)
        if self.refine_cfo:
            with span("gfdm.service.refine_cfo", host_s):
                bursts, _ = pp.refine_cfo_planar(cfg, bursts)
        with span("gfdm.service.receive", host_s):
            if self.engine == "fused":
                out = fk.receive_bursts_fused(
                    cfg, bursts.contiguous(), ic_iterations=self.ic_iterations,
                    equalizer=self.equalizer, constellation=self.constellation,
                )
            else:
                out = pp.receive_bursts_planar(
                    cfg, bursts, ic_iterations=self.ic_iterations, equalizer=self.equalizer,
                    constellation=constellation_points(self.constellation),
                    method=self.method, dtype_name="float32",
                )
        out["detection"] = det
        out["found"] = found
        if self.fec == "conv":
            with span("gfdm.service.decode", host_s):
                out["bits"] = self._fec_decode(out["data"], out["snr_lin"])
        return out

    def _sp_step(self, chunks: torch.Tensor) -> dict:
        """Sample-axis-sharded step over shards j0..j1 - 1 of a chunk batch on
        one device: ``chunks`` holds their owned samples and the next sub-
        chunk's head, or the chunk's lookahead tail after the last shard,
        (n, 2, (j1 - j0) * sub + halo). Each sub-chunk's window is itself
        plus that head or tail, so the windows are ``chunks.unfold``: one
        detection, extraction and receiver call over n * (j1 - j0) windows,
        chunk-major. On one device (j0 = 0, j1 = sp) ``chunks`` is the whole
        halo-extended chunk."""
        sub, halo = self._sub, self.halo
        win = chunks.unfold(-1, sub + halo, sub)  # (n, 2, shards, sub + halo)
        return self._chunk_step(win.transpose(1, 2).reshape(-1, 2, sub + halo), sub)

    def _slot_offsets(self, n: int) -> np.ndarray:
        """Per-slot sample offset of each slot's sub-chunk in the recording."""
        k = max(1, self.max_bursts_per_chunk)
        pat = np.repeat(np.arange(self.sp_shards) * self._sub, k)
        return np.repeat(np.arange(n) * self.chunk_len, self._spc) + np.tile(pat, n)

    def _padded_batch(self, n: int) -> int:
        """Pad a batch size up the geometric shape ladder (x dp alignment).

        Bounds the set of batch shapes (and so of cached allocations) to
        the ladder's length while wasting < 2x compute on partial batches.
        """
        size = self.batch_chunks
        while size < n:
            size *= 2
        dp = self.mesh.shape["dp"]
        return ((size + dp - 1) // dp) * dp

    def _plan(self, size: int) -> list:
        """The steps of a ``size``-chunk batch: [(c0, c1, runs)], chunks
        c0..c1 - 1 (consecutive 'dp' rows with the same device layout) and
        ``runs`` [(device, j0, j1)]: shards j0..j1 - 1 of those chunks run
        as one step on ``device``."""
        plan = self._plans.get(size)
        if plan is None:
            b = size // self.mesh.shape["dp"]
            plan = []
            for r, row in enumerate(self.mesh.devices):
                runs = device_runs(row)
                if plan and plan[-1][2] == runs:
                    plan[-1] = (plan[-1][0], (r + 1) * b, runs)
                else:
                    plan.append((r * b, (r + 1) * b, runs))
            plan = self._plans[size] = plan
        return plan

    def _stage(self, chunks: np.ndarray, profiled: bool | None = None):
        """Copy one (n, 2, ext) batch into a new host buffer, zero-padded up
        the shape ladder and pinned when the mesh has a card; returns
        (buffer, n). Touches host memory alone, so ``serve()`` runs it on
        its stager thread, passing the loop thread's profiler state as
        ``profiled`` (``utils.profiling.span``). A buffer is never reused
        here: torch's pinned allocator hands a block out again only once
        the copy enqueued from it has run."""
        if chunks.ndim != 3 or chunks.shape[1:] != (2, self.ext):
            raise ValueError(f"a batch is (n, 2, {self.ext}) samples, got {chunks.shape}")
        n = chunks.shape[0]
        cuda = any(d.type == "cuda" for d in self.mesh.distinct_devices())
        with span("gfdm.service.stage", self.stats.host_s, profiled):
            host = torch.empty((self._padded_batch(n), 2, self.ext), dtype=torch.float32,
                               pin_memory=cuda)
            host_np = host.numpy()
            host_np[:n] = chunks
            host_np[n:] = 0.0
        return host, n

    def _enqueue(self, host: torch.Tensor, n: int):
        """Copy a staged batch to the mesh and enqueue its steps; returns
        ([(c0, c1, j0, j1, device outputs)], n). Makes no host sync.

        Each block of rows is copied once, to the device of its first
        shard; a run of shards on another device takes its samples (with
        the next sub-chunk's head or the lookahead tail) from there with a
        device-to-device copy."""
        host_s = self.stats.host_s
        outs = []
        for c0, c1, runs in self._plan(host.shape[0]):
            with span("gfdm.service.h2d", host_s):
                staged = move(host[c0:c1], runs[0][0])
                parts = [move(staged[..., j0 * self._sub : j1 * self._sub + self.halo], dev)
                         for dev, j0, j1 in runs]
            for (_dev, j0, j1), part in zip(runs, parts):
                with span("gfdm.service.step", host_s):
                    outs.append((c0, c1, j0, j1, self._step(part)))
        return outs, n

    def _dispatch(self, chunks: np.ndarray):
        """Stage one batch and enqueue its steps in turn (``_stage``,
        ``_enqueue``)."""
        return self._enqueue(*self._stage(chunks))

    def _fetch(self, outs: list, n: int, fetch: tuple = ()):
        """Wait for the card, fetch one dispatched batch to the host and
        account stats."""
        host_s = self.stats.host_s
        with span("gfdm.service.fetch.wait", host_s):
            # the wait the first copy would make, made explicit: every batch
            # enqueued on the stream so far, this one included
            for dev in {o[-1]["data"].device for o in outs}:
                if dev.type == "cuda":
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(dev))
                    done.synchronize()
        with span("gfdm.service.fetch.copy", host_s):
            got = self._host_outputs(outs, n, fetch)
        with span("gfdm.service.account", host_s):
            self.stats.batches += 1
            self.stats.chunks += n
            self.stats.samples += n * self.chunk_len
            nf = int(got["found"].sum())
            self.stats.bursts_found += nf
            if nf:
                snr = np.maximum(got["snr_lin"][got["found"]], 1e-9)
                self.stats.snr_db_sum += float(np.sum(10.0 * np.log10(snr)))
        return got

    def _host_outputs(self, outs: list, n: int, fetch: tuple) -> dict:
        """The dispatched batch's outputs as host arrays, slots trimmed to
        ``n`` chunks."""
        # slots are chunk-major; padded chunks land at the end and are trimmed
        slots = n * self._spc
        keys = ("data", "snr_lin", "found", "start", "cfo") + (
            ("bits",) if "bits" in outs[0][-1] else ()) + tuple(fetch)

        def host(out, key):
            t = out["detection"][key].reshape(-1) if key in ("start", "cfo") else out[key]
            return t.cpu().numpy()

        if len(outs) == 1:
            return {key: host(outs[0][-1], key)[:slots] for key in keys}
        # place each step's slots at chunk * spc + shard * k + pick
        k = max(1, self.max_bursts_per_chunk)
        got = {}
        for c0, c1, j0, j1, out in outs:
            idx = ((np.arange(c0, c1)[:, None, None] * self.sp_shards
                    + np.arange(j0, j1)[None, :, None]) * k
                   + np.arange(k)[None, None, :]).reshape(-1)
            for key in keys:
                part = host(out, key)
                if key not in got:
                    got[key] = np.empty((max(o[1] for o in outs) * self._spc,)
                                        + part.shape[1:], part.dtype)
                got[key][idx] = part
        return {key: v[:slots] for key, v in got.items()}

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

        ``max_batches`` bounds the pulls, and so the dispatches, made by
        this call. The loop is software-pipelined: a stager thread, which
        lives as long as the call, copies batch b + 1 into its host buffer
        while the loop's thread enqueues batch b on the card and fetches;
        up to ``pipeline_depth`` batches are enqueued before the oldest one
        is fetched. Every pulled batch is dispatched and delivered, the
        last one staged included; an exception on the stager is raised
        here. The stager finishes copying a batch before the loop pulls
        the next one, so a source may hand out one array that it refills
        on every call. Ring overflow is accounted per call: if the source
        exposes a cumulative ``dropped`` counter, its growth since the last
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
            with span("gfdm.service.sink", self.stats.host_s):
                sink(out)

        host_s = self.stats.host_s
        stager = ThreadPoolExecutor(max_workers=1, thread_name_prefix="gfdm-stage")
        pulled = 0

        def pull_and_stage():
            """The next batch handed to the stager: (future, base), or None
            once the source is dry or ``max_batches`` are pulled."""
            nonlocal pulled
            if max_batches is not None and pulled >= max_batches:
                return None
            with span("gfdm.service.pull", host_s):
                got = pull()
            if got is None:
                return None
            pulled += 1
            chunks, base = got
            return stager.submit(self._stage, np.asarray(chunks),
                                 torch.autograd._profiler_enabled()), base

        depth = max(1, int(self.pipeline_depth))
        pending: deque = deque()
        try:
            ahead = pull_and_stage()
            while ahead is not None:
                staged, base = ahead
                self.stats.staged_ahead += staged.done()
                with span("gfdm.service.stage.wait", host_s):
                    host, n = staged.result()
                # batch b's copy is done: pull b + 1 and stage it while b is
                # enqueued and the oldest batch fetched
                ahead = pull_and_stage()
                pending.append(self._enqueue(host, n) + (base,))
                if len(pending) > depth:
                    emit(pending.popleft())
            while pending:
                emit(pending.popleft())
        finally:
            stager.shutdown(cancel_futures=True)
        # drops that land after the final pull still belong to this call
        account_drops()
        return self.stats
