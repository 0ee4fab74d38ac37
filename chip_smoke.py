#!/usr/bin/env python3
"""Run the PyTorch port's main paths end to end on one CUDA card and check them.

    python3 chip_smoke.py    # canonical config: link B = 65,536 bursts,
                             # service 4,096 chunks x 2,048 samples

The card's integration run: each kernel against its plain version at the
main paths' shapes, then each public path at full width, with its launches
counted. tests/test_torch_gpu.py (pytest -m gpu) holds the kernels at the
other shapes and options; gfdm_tpu_torch/benchmarks/kernels.py times them
(its table of checks is phase 3's, its timer and card line the timed lines
here take). Phases, one line each or more, numbered as the documents cite
them (no phase 5); any failure exits non-zero and prints no result:

1. device  - requires CUDA; prints the card's name and power limit.
2. build   - compiles the CUDA kernels of gfdm_tpu_torch/csrc with nvcc;
             ptxas's registers and spills of each kernel.
3. check   - benchmarks.kernels.checks: each kernel through its public
             wrapper on card tensors, against its plain version on the same
             inputs, at the shapes benchmarks/kernels.py times: Tx, receiver
             (conv and matmul IC, the metrics, its launches, the bursts
             unwritten), link (matmul, conv, bf16 stacks) and CDD Tx at
             65,536 bursts; the factored Tx and receiver at K = 256, 512,
             1,024 (and 512 at M = 5), the estimator receiver and its GEMM at
             K = 128; the four superseded receivers at 65,536; both detection
             kernels on the service's 4,096 chunks and the sp = 2 service's
             8,192 windows (traces, starts, peak fields); the chain in f32,
             bf16 and int8 at 65,536 rows; the Viterbi kernel at 4,096
             codewords of T = 468 and 1,404 against the CPU, bit for bit.
4. main    - the entry step (link_single_fused, matmul IC) and
             link_step_fused (Tx kernel -> the receiver's stages) at full
             batch, with the launch counters reset just before (the link
             fused.link_launches, the receiver fused.rx_launches); EVM
             against the plain versions and the planar torch-op link.
6. service - StreamingReceiver(engine="fused") on the synthetic service
             streams (entry.service_stream, seed 0): friendly (20 dB AWGN,
             one burst a chunk, k = 1) under DETECT_IMPL "pallas2" (lean
             detection kernel), "pallas" (front kernel) and "twostage"
             (torch ops); impaired (8-tap multipath, CFO up to +-0.2, 0-2
             bursts a chunk, k = 2) under "pallas" and "twostage". Each step
             runs once under torch's sync debug mode, which fails on any
             host sync inside it; then once with the launch counters reset
             just before, through StreamingReceiver.step: found fraction,
             device-step samples/s (CUDA events), launches (one receiver
             call a step), and on the friendly stream the EVM of the found
             slots against the sent payload; then one serve() loop (batch
             256, super-batch 1,024, pipeline depth 2).
7. large K - the large-K link link_step_factored (Tx kernel -> torch-op
             estimate -> receiver kernel -> demap) at K = 512, B = 4,096
             and the estimator="fused" link at K = 128, each with the launch
             counters reset just before and read just after: hard decisions
             against the payload, EVM against the plain versions' and the
             torch-op method="fast" chain's.
8. service - the service (fused engine vs the torch-op xla engine) on
             4,096-chunk qam16 (mmse_cnr, 30 dB) and qam64 (mmse, 36 dB)
             streams, with the launch counters reset just before.
9. cdd     - with the counters reset, the two-antenna CDD link
             (entry.cdd_link: the example's taps) at 34 dB, no symbol error
             allowed, and at 28 dB beside its plain version.
10. chain  - the link's GEMM chain (benchmarks/int8_gauss.py's shapes and
             inputs) at B = 65,536: with the launch counters reset just
             before, one chain step in each of f32, bf16 and int8, each
             with chain._KERNELS launches.
11. coded  - the coded modem through both services: a seeded payload of
             4,096 coded QPSK bursts framed by cli.payload_to_symbols(fec=
             "conv"), StreamingTransmitter(cycle_samples=2,048).serve (one
             burst a cycle, the Tx kernel), the stream delayed by a seeded
             offset (each burst whole in its owned chunk) plus AWGN at 10 dB,
             runtime.stream.chunk_with_lookahead, then
             StreamingReceiver(engine="fused", fec="conv", batch_chunks=
             4,096).serve, under the default DETECT_IMPL, "pallas2" and
             "pallas", each with the launch counters reset just before and
             read just after: found >= 0.999, CRC-clean share >= 0.99, the
             clean payloads equal to those sent, one decoder launch a
             batch; and once more as coded 64-QAM (constellation="qam64", 4
             IC passes, 25 dB; T = 1,404) under the default DETECT_IMPL.
             Then eval.sensitivity.modem_sensitivity at 4,096 bursts a point
             (4 and 10 dB: found >= 0.999, CRC >= 0.9 / 0.95, not lower at
             10 dB); the found slots' soft bits card against CPU (1e-5
             relative) and their decoded bits (the share of slots differing,
             <= 1e-3); the coded and the uncoded service step (CUDA events,
             friendly stream, default DETECT_IMPL) with the decoder's share,
             and their launches (torch.profiler).
12. live   - the live-ring modem at the canonical config: 4,096 seeded QPSK
             bursts, one a 2,048-sample cycle. (a) StreamingTransmitter(
             batch_bursts=256).serve into a native StreamBuffer holding the
             whole stream (plus the halo flush), then StreamingReceiver(
             engine="fused", 256 / 1,024).serve from it under "pallas2",
             with the launch counters reset just before: all found,
             start_abs on the cycle grid, every decision right, the Tx,
             detection and receiver kernels each launched. (b) the same
             through UdpSink -> UdpIngest on a free loopback port under
             "pallas", the sender paced on the ring's chunk count (the
             ingest thread reports its count only at the end), ingested ==
             sent + halo. (c) push_sc16 against push of the converted
             samples: equal chunks. (d) runtime.receiver.receive_stream on
             complex64 over the friendly stream's 4,096 chunks, card against
             CPU (starts equal, data within 5e-4 on whole bursts), and the
             simulated link of gfdm_tpu/cli.py's simulate (Tx, shape, the
             3-tap multipath, AWGN at 15 dB, receive_stream) on the card and
             the CPU with the same noise: decisions equal. Host wall times of
             Tx serve, ring push, the sink's push and the pacing waits, ring
             pull and Rx serve; CUDA-event times of the Tx kernel and the
             receive steps; the live loop's samples/s and the card's share.
13. app    - the application layer at the canonical config. (a) a seeded 1
             MiB payload through `python -m gfdm_tpu_torch tx` then `rx`,
             each a process on the card: QPSK in a cf32 file (9,280
             bursts), qam16 with --fec conv in an sc16 file (9,363 bursts):
             both exit 0, every burst CRC-clean, the payload back
             byte-equal; the host wall of each command and the card time
             of rx_file's receive_stream on the capture (CUDA events). (b)
             `rx --udp-port` on a free loopback port fed the QPSK capture
             as sc16 datagrams by UdpSink (paced, and held while the
             receiving socket's queue in /proc/net/udp is over 3
             datagrams), then the empty datagram: the payload back
             byte-equal, the socket's drop count 0. (c) cli.simulate at 4,096 bursts
             at the JAX tests' settings: 20 dB every burst clean, the
             estimate tracking the nominal SNR dB for dB (12 dB), the coded
             link at 4 dB through the multipath CRC-clean on at least 0.9 of
             the bursts, the uncoded one on less than half. (d)
             eval.ber_sweep at examples/ber_sweep.py's grids (qpsk, qam16,
             qam64) at 4,096 bursts a point, and at 1,024 card against CPU
             on the same generator (bit errors within max(2, 1e-4 x bits),
             EVM 1e-4 relative); the card time of one point. (e)
             eval.coded.coded_vs_uncoded at examples/coded_link.py's points:
             coded BER <= uncoded from 3 dB up; a coded point's card time
             and its decoder's share. (f) the block flowgraph (mapper,
             transmitter, sync + extraction, estimator, receiver, demapper)
             card against CPU (Tx 2e-5, data 5e-4, starts equal, every
             decision right). (g) the legacy modulator on 4,096 grids, card
             against CPU and against a float64 product, 2e-5 of the largest
             output. (h) eval.spectrum.spectrum_study(4,096 bursts), card
             against CPU within 1e-6 relative, OOB ordered gfdm_frame >
             gfdm_core > ofdm. With the launch counters reset before (c) and
             read after (h): the application layer runs the complex chain
             and the planar torch-op link, no kernel of the port.
14. parallel - the parallel layer on a virtual mesh of the card. (a) the
             friendly service stream (4,096 chunks) through
             StreamingReceiver(engine="fused", sp_shards=2, mesh=make_mesh(
             [card] * 2, dp=1, sp=2)) against the same service at sp = 1
             under DETECT_IMPL "twostage", "pallas2" and "pallas", through
             step (with the launch counters reset just before it and read
             just after: one receiver call a step, one detection launch)
             and serve (1,024-chunk batches): no sp = 1 burst missed, each
             at its start_abs with the same decisions (a few samples off
             only at a sub-chunk boundary), extra found slots under 1% of
             the chunks; each step's time against sp = 1's (CUDA events)
             and a StageTimer split (windows, detect, extract, refine,
             receive). (b) parallel.detect_bursts_sharded on eight copies of
             the card (dp = 2, sp = 4) at tests/test_parallel.py's four
             scenarios, complex and planar, k = 1 and 2, against the same
             call on the CPU. (c) entry.dryrun_multichip(8) on the card.
             (d) parallel.multihost.launch: two processes sharing the card
             in one gloo group, 4,096 chunks, against one process (parity,
             the metrics' all-reduce, the bursts expected). (e) the seven
             examples of the slice on the card, each with its own check
             (multichip_sharding in its own process, dryrun_multihost
             spawning its workers), the kernels each should launch.

Then the card line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

from gfdm_tpu_torch.benchmarks.kernels import card_line, ptxas_lines, reset_launches, time_ms
from gfdm_tpu_torch.benchmarks.kernels import checks as kernel_checks
from gfdm_tpu_torch.benchmarks.kernels import launches as read_launches

B = 65536  # bursts per main-path step: 49 M samples at the canonical config
TOL = {
    # float32 products summed in another order: bursts ~1e-6, and the
    # receiver's ZF divide and IC amplify that by < 100
    "tx": 2e-5,
    "data": 1e-4,
    "evm": 1e-4,
    "evm_max": 0.025,  # the clean-loopback floor is 0.018 (JAX on CPU)
    # service: found fraction floor, kernel paths vs the torch-op twostage
    "found_min": 0.999, "found_vs_twostage": 1e-3, "evm_vs_twostage": 1e-3,
    # the service's fused vs xla engines on found slots whose last IC
    # decisions agree, and the share that differ
    "engines_data": 2e-3, "engines_flipped_share": 1e-2,
    # phase 11, the coded services link at CODED_SNR_DB: the share of sent
    # bursts whose CRC-clean payload comes back; the share of found slots
    # whose decoded bits differ between the card and the CPU on the same
    # LLRs (equal branch sums, so only an argmax over a float tie could)
    "crc_min": 0.99, "decode_differ": 1e-3,
}
N_CHUNKS = 4096  # service batch: 8.4 M owned samples a step
CHUNK_LEN = 2048
CODED_SNR_DB = 10.0  # phase 11's services link
QAM64_SNR_DB = 25.0  # phase 11's coded 64-QAM services link (4 IC passes)
B_CHAIN = 65536  # phase 10: the link's batch
# phase 7: the large-K link at full width; estimator="fused" runs at K = 128,
# where its dense (4K, 2N) E is 4.7 MB
K_FULL, K_ESTIMATOR, B_LARGE_K = 512, 128, 4096
# phase 12: bursts of the live loop (one a 2,048-sample cycle), the transmit
# service's batch, the receive service's batch and super-batch, the longest
# wait for the UDP ingest thread; the complex chain card vs CPU at the CPU
# parity tests' limits (tests/test_torch_receiver.py); the simulated link of
# gfdm_tpu/cli.py's simulate
N_LIVE, LIVE_TX_BATCH, LIVE_RX_BATCH, LIVE_RX_MAX, LIVE_WAIT_S = 4096, 256, 256, 1024, 10.0
LIVE_TOL = {"data": 5e-4, "snr_rtol": 1e-3}
SIM_TAPS, SIM_SNR_DB = np.array([1.0, 0.25 + 0.15j, -0.1j]), 15.0
# phase 13: a 1 MiB payload through the CLI; simulate, the sweeps, the block
# flowgraph, the legacy modulator and the spectrum study at 4,096 bursts; the
# sweeps card vs CPU at 1,024 bursts a point; the coded simulate at 4 dB held
# to the CRC share the JAX package's sensitivity test holds at 4 dB
APP_PAYLOAD, APP_SEED, APP_BURSTS, APP_BER_CMP = 1 << 20, 18, 4096, 1024
APP_CODED_CRC_MIN, APP_OFFSET, APP_CLI_TIMEOUT_S = 0.9, 300, 120.0
# the sender's pace: at 8e6 samples/s, eight datagrams at a time, the ingest
# thread lost 8 of 4,640 datagrams to the socket's default buffer; at 4e6 one
# at a time, 4 of 4,640 once in five runs (the 212,992-byte default holds 12
# datagrams, 12 ms). So the sender also waits while the receiving socket's
# queue (/proc/net/udp) holds more than APP_UDP_QUEUE bytes, 3 datagrams
APP_UDP_DATAGRAM, APP_UDP_RATE = 4096, 4e6  # samples a datagram, samples/s sent
APP_UDP_QUEUE = 3 * 17216  # bytes the kernel counts for 3 datagrams of 4,096 sc16
# phase 14: the sp service's shards (the card twice); the sharded detection's
# virtual mesh and its card-vs-CPU limits (cfo on found slots, bursts relative
# to their peak where the CFOs agree: tests/test_torch_parallel.py's); the
# multi-process serve's processes, chunks and batch; the longest a spawned
# process may take. The sp = 2 service against sp = 1, as a share of the
# chunks: bursts missed or moved at a sub-chunk boundary and extra found
# slots (the JAX package's sp service the same on the CPU: a preamble whose
# CP straddles the boundary fails the right shard's CFAR, the left shard
# takes the peak's shoulder, a burst's tail passes as a pick: 16-17 of the
# 4,096 chunks on an H100). The multi-process stream's CFAR false alarms in
# its empty chunks, as a share of the chunks (1 of 4,096, chunk 1,324, JAX
# the same)
SP_SHARDS, PAR_DP, PAR_SP, PAR_PROCS, PAR_CHUNKS, PAR_BATCH = 2, 2, 4, 2, 4096, 256
PAR_TOL = {"cfo": 1e-6, "bursts": 1e-5}
PAR_TIMEOUT_S, SP_DIFFER_SHARE, PAR_FALSE_ALARM_SHARE = 300.0, 0.01, 1e-3


def _max_abs(a, b) -> float:
    return float((a - b).abs().max())


def _max_rel(a, b) -> float:
    return float(((a - b).abs() / (b.abs() + 1e-12)).max())


def _rel_excess(a, b, atol: float, rtol: float) -> float:
    """max(|a - b| - rtol |b|) / atol: <= 1 where a is within atol + rtol |b|."""
    return float(((a - b).abs() - rtol * b.abs()).max()) / atol


def _service_phase(torch, cfg, dev, streams, card, check, failures):
    """Phase 6: the streaming receive service through StreamingReceiver."""
    from gfdm_tpu_torch.kernels import fused
    from gfdm_tpu_torch.ops import planar_pipeline as pp
    from gfdm_tpu_torch.runtime.service import ServiceStats, StreamingReceiver

    default_impl = pp.DETECT_IMPL
    setups = (("friendly", "pallas2", 1), ("friendly", "pallas", 1),
              ("friendly", "twostage", 1), ("impaired", "pallas", 2),
              ("impaired", "twostage", 2))
    kernel_of = {"pallas2": "detect_lean", "pallas": "detect_front"}
    res = {}
    samples = N_CHUNKS * CHUNK_LEN
    for stream_name, impl, k in setups:
        chunks, counts, payload = streams[stream_name]
        pp.DETECT_IMPL = impl
        rx = StreamingReceiver(cfg, chunk_len=CHUNK_LEN, batch_chunks=N_CHUNKS,
                               engine="fused", max_bursts_per_chunk=k, device=dev)
        dev_chunks = torch.from_numpy(chunks).to(dev)
        rx._step(dev_chunks)  # warm-up: constants, cuBLAS/cuDNN handles
        torch.cuda.synchronize()
        # the step must only enqueue work: any host sync in it raises here
        torch.cuda.set_sync_debug_mode("error")
        try:
            rx._step(dev_chunks)
        except RuntimeError as exc:
            failures.append(f"service step [{stream_name}, {impl}] waits for the "
                            f"card: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = rx.step(chunks)  # the user's entry: copy in, step, fetch
        host_s = time.perf_counter() - t0
        run = read_launches()
        ms = time_ms(lambda: rx._step(dev_chunks))
        found = float(out["found"].sum()) / float(counts.sum())
        fmask = out["found"]
        shapes = out["data"].shape == (N_CHUNKS * k, 2, cfg.n_data_symbols)
        if not (shapes and np.isfinite(out["data"][fmask]).all()):
            failures.append(f"service[{stream_name},{impl}]: outputs shapes={shapes}")
        need = [kernel_of[impl], "rx"] if impl in kernel_of else ["rx"]
        for key in need:
            if run[key] < 1:
                failures.append(f"kernel {key} was not launched on the service path "
                                f"({stream_name}, {impl})")
        if run["rx"] != fused.rx_launches(2):
            failures.append(f"service[{stream_name},{impl}]: {run['rx']} receiver launches "
                            f"a step, expected {fused.rx_launches(2)} (one receiver call)")
        if impl not in kernel_of and (run["detect_front"] or run["detect_lean"]):
            failures.append(f"twostage launched a detection kernel: {run}")
        evm = float("nan")
        if stream_name == "friendly":
            d, p = out["data"][fmask], payload[fmask]
            evm = float(np.sqrt(np.sum((d - p) ** 2) / np.sum(p**2)))
        res[(stream_name, impl)] = (found, evm)
        print(f"[6 service] {stream_name} k={k} DETECT_IMPL={impl}: found="
              f"{int(out['found'].sum())}/{int(counts.sum())}={found:.6f} "
              + (f"evm_found={evm:.6f} " if stream_name == "friendly" else "")
              + f"device step {ms:.3f} ms = {samples / (ms / 1e3):.4e} samples/s "
              f"(host step incl. copies {host_s * 1e3:.1f} ms) launches="
              f"{{detect_front: {run['detect_front']}, detect_lean: "
              f"{run['detect_lean']}, rx: {run['rx']}}} ({N_CHUNKS} chunks x "
              f"{CHUNK_LEN}, {card})", flush=True)
        del dev_chunks, out
    parts = []
    for stream_name, impl in (("friendly", "pallas2"), ("friendly", "pallas"),
                              ("impaired", "pallas")):
        found, evm = res[(stream_name, impl)]
        found_ts, evm_ts = res[(stream_name, "twostage")]
        parts.append(check(f"{stream_name}/{impl}:1-found", 1.0 - found,
                           1.0 - TOL["found_min"]))
        parts.append(check(f"|found-twostage|", abs(found - found_ts),
                           TOL["found_vs_twostage"]))
        if stream_name == "friendly":
            parts.append(check("|evm-twostage|", abs(evm - evm_ts),
                               TOL["evm_vs_twostage"]))
    print("[6 service] " + " ".join(parts), flush=True)

    # the host loop: serve() over the friendly stream through the lean kernel
    pp.DETECT_IMPL = "pallas2"
    chunks = streams["friendly"][0]
    rx = StreamingReceiver(cfg, chunk_len=CHUNK_LEN, batch_chunks=256,
                           max_batch_chunks=1024, engine="fused", pipeline_depth=2,
                           device=dev)

    def source():
        it = iter(range(0, N_CHUNKS, 1024))
        return lambda: None if (i := next(it, None)) is None else chunks[i : i + 1024]

    rx.serve(source(), lambda out: None, max_batches=1)  # warm the ladder
    rx.stats = ServiceStats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = rx.serve(source(), lambda out: None)
    dt = time.perf_counter() - t0
    found = stats.bursts_found / N_CHUNKS
    print(f"[6 serve] DETECT_IMPL=pallas2 batches={stats.batches} chunks={stats.chunks} "
          f"found={found:.6f} {dt * 1e3:.1f} ms = {samples / dt:.4e} samples/s "
          f"host loop (batch 256, super-batch 1024, depth 2, {card}) "
          + check("serve:1-found", 1.0 - found, 1.0 - TOL["found_min"]), flush=True)
    if stats.chunks != N_CHUNKS:
        failures.append(f"serve() received {stats.chunks} of {N_CHUNKS} chunks")
    pp.DETECT_IMPL = default_impl


def _factored_link_plain(cfg, data, estimator: str):
    """The factored link through the kernels' plain versions: Tx, the
    channel (torch-op estimate, or the dense estimator inside the plain
    receiver), receiver, demap."""
    from gfdm_tpu_torch.kernels import fused

    bursts = fused._tx_factored_plain(cfg, data, 0)
    chan = fused._fast_channel(cfg, bursts) if estimator == "fast" else None
    _chan, sym = fused._rx_factored_plain(cfg, bursts, chan, 2)
    return sym[..., fused._factored_consts(cfg, data.device)["demap_idx"]]


def _large_k_phase(torch, dev, check, failures) -> None:
    """Phase 7: the large-K link through the user's entry points."""
    from gfdm_tpu_torch.entry import large_k_config, planar_payload
    from gfdm_tpu_torch.kernels import fused
    from gfdm_tpu_torch.ops.planar_pipeline import evm, link_step_planar

    batch = {K_FULL: B_LARGE_K, K_ESTIMATOR: B_LARGE_K}
    cfgs = {K: large_k_config(K) for K in batch}
    payload = {K: torch.from_numpy(planar_payload(cfgs[K], batch[K], seed=K)).to(dev)
               for K in batch}

    # each path's launches counted from zero (estimator="fused": the
    # estimator GEMM under "rx_factored", then the receiver under
    # "rx_factored_chan")
    links, runs = {}, {}
    host_s = 0.0
    for K, est in ((K_FULL, "fast"), (K_ESTIMATOR, "fused")):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        links[(K, est)] = fused.link_step_factored(cfgs[K], payload[K], estimator=est)
        torch.cuda.synchronize()
        host_s += time.perf_counter() - t0
        run = read_launches()
        runs[est] = {key: run[key] for key in ("tx_factored", "rx_factored", "rx_factored_chan")}
    fast, fusd = runs["fast"], runs["fused"]
    row6 = {"rx_estimate_kernel": fusd["rx_factored"], "rx_factored_kernel": fusd["rx_factored_chan"]}
    if (fast["tx_factored"], fast["rx_factored_chan"], fast["rx_factored"]) != (1, 1, 0) \
            or fusd["tx_factored"] != 1 or tuple(row6.values()) != (1, 1):
        failures.append(f"large-K links: launches {fast} (estimator=fast) and {fusd} "
                        f"(estimator=fused), expected one Tx and one receiver a link, the "
                        f"estimator GEMM on the fused one only")
    for (K, est), (d_hat, evm_k) in links.items():
        data = payload[K]
        evm_k = float(evm_k)
        evm_plain = float(evm(_factored_link_plain(cfgs[K], data, est), data))
        parts = [f"evm={evm_k:.6f} plain={evm_plain:.6f}",
                 check("|d|", abs(evm_k - evm_plain), TOL["evm"])]
        if est == "fast":
            evm_chain = float(link_step_planar(cfgs[K], data, method="fast")[2])
            parts += [f"torch-op fast chain={evm_chain:.6f}",
                      check("|d_chain|", abs(evm_k - evm_chain), TOL["evm"])]
        wrong = int((torch.sign(d_hat) != torch.sign(data)).sum())
        ok = tuple(d_hat.shape) == tuple(data.shape) and bool(torch.isfinite(d_hat).all())
        if not ok:
            failures.append(f"large-K link K={K}: outputs shape/finite")
        print(f"[7 main] K={K} B={batch[K]} estimator={est} "
              + " ".join(parts + [check("evm", evm_k, TOL["evm_max"]),
                                  check("wrong_decisions", float(wrong), 0.0)]),
              flush=True)
    print(f"[7 main] launches: estimator=fast link {fast}, estimator=fused link {fusd} "
          f"(row 6: rx_estimate_kernel {row6['rx_estimate_kernel']} + rx_factored_kernel "
          f"{row6['rx_factored_kernel']}) host {host_s * 1e3:.1f} ms", flush=True)
    del links


def _levels(torch, x, name: str):
    """Per-axis decision levels of planar symbols (torch or numpy): the
    nearest point of the square Gray constellation ``name``."""
    from gfdm_tpu_torch.kernels import fused

    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    return fused._ic_level(t, name)


def _options_phase(torch, cfg, dev, card, check, failures) -> None:
    """Phase 8: the fused-engine service at qam16 / qam64 against the
    torch-op xla engine."""
    from gfdm_tpu_torch.entry import service_stream
    from gfdm_tpu_torch.kernels import fused
    from gfdm_tpu_torch.runtime.service import StreamingReceiver

    samples = N_CHUNKS * CHUNK_LEN
    for name, eq, snr_db in (("qam16", "mmse_cnr", 30.0), ("qam64", "mmse", 36.0)):
        chunks, counts, payload = service_stream(cfg, N_CHUNKS, CHUNK_LEN, snr_db, False,
                                                 np.random.default_rng(0), name)
        kw = dict(chunk_len=CHUNK_LEN, batch_chunks=N_CHUNKS, equalizer=eq,
                  constellation=name, device=dev)
        fused_rx = StreamingReceiver(cfg, engine="fused", **kw)
        xla_rx = StreamingReceiver(cfg, engine="xla", **kw)
        # the last IC decisions are made on the symbols after one iteration:
        # slots where the engines decide differently there are left out
        last = [StreamingReceiver(cfg, engine=engine, ic_iterations=1, **kw).step(
            chunks)["data"] for engine in ("fused", "xla")]
        dev_chunks = torch.from_numpy(chunks).to(dev)
        fused_rx._step(dev_chunks)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        out = fused_rx.step(chunks)
        run = read_launches()
        if run["rx"] != fused.rx_launches(2):
            failures.append(f"service[{name}]: {run['rx']} receiver launches a step, expected "
                            f"{fused.rx_launches(2)} (one receiver call)")
        ref = xla_rx.step(chunks)
        ms = time_ms(lambda: fused_rx._step(dev_chunks))
        ms_x = time_ms(lambda: xla_rx._step(dev_chunks))
        f = out["found"]
        found = float(f.sum()) / float(counts.sum())
        both = f & ref["found"]
        lv_f = _levels(torch, last[0][both], name)
        lv_x = _levels(torch, last[1][both], name)
        agree = ~(lv_f != lv_x).reshape(lv_f.shape[0], -1).any(dim=1).numpy()
        flipped = float((~agree).sum()) / max(int(both.sum()), 1)
        e = float(np.abs(out["data"][both][agree] - ref["data"][both][agree]).max())
        # the payload's decisions: the fused engine no worse than the xla one
        wrong = int((_levels(torch, out["data"][f], name)
                     != _levels(torch, payload[f], name)).sum())
        wrong_x = int((_levels(torch, ref["data"][ref["found"]], name)
                       != _levels(torch, payload[ref["found"]], name)).sum())
        if not np.isfinite(out["data"][f]).all():
            failures.append(f"service[{name}]: non-finite found-slot data")
        print(f"[8 service] {name} {eq} {snr_db:.0f} dB: found={int(f.sum())}/"
              f"{int(counts.sum())} step {ms:.3f} ms = {samples / (ms / 1e3):.4e} "
              f"samples/s (xla engine {ms_x:.3f} ms) launches={{rx: {run['rx']}}} "
              f"wrong decisions fused {wrong} xla {wrong_x} of {int(f.sum()) * 2 * cfg.n_data_symbols} "
              + " ".join([check("1-found", 1.0 - found, 1.0 - TOL["found_min"]),
                          check("found!=xla", float((f != ref["found"]).sum()), 0.0),
                          check("flipped_share", flipped, TOL["engines_flipped_share"]),
                          check("data_vs_xla", e, TOL["engines_data"]),
                          check("wrong-xla", float(wrong - wrong_x),
                                0.01 * wrong_x + 2)])
              + f" ({N_CHUNKS} chunks x {CHUNK_LEN}, {card})", flush=True)
        del dev_chunks, out, ref


def _cdd_phase(torch, dev, data, check, failures) -> None:
    """Phase 9: the two-antenna CDD link (the CDD transmitter kernel, then
    the receiver's stages)."""
    from gfdm_tpu_torch import GfdmConfig
    from gfdm_tpu_torch.entry import cdd_channel, cdd_link
    from gfdm_tpu_torch.kernels import fused

    Bc = data.shape[0]
    flat = data.reshape(Bc, -1)
    cfg_c = GfdmConfig(cyclic_shifts=(0, 2))
    # the two-antenna link through the user's entry point, launches counted
    reset_launches()
    torch.cuda.synchronize()
    d34 = cdd_link(cfg_c, data, 34.0, 9)
    torch.cuda.synchronize()
    run = read_launches()
    for key in ("tx_cdd", "rx"):
        if run[key] < 1:
            failures.append(f"kernel {key} was not launched on the CDD link")
    wrong34 = int((torch.sign(d34) != torch.sign(data)).sum())
    ok = tuple(d34.shape) == tuple(data.shape) and bool(torch.isfinite(d34).all())
    if not ok:
        failures.append("CDD link: outputs shape/finite")
    # 28 dB (the example's SNR): the kernels' path and the plain versions'
    # on the same channel and noise
    rx_k = cdd_channel(fused.tx_cdd_fused(cfg_c, data), 28.0, 10)
    d_k = fused.receive_bursts_fused(cfg_c, rx_k, ic_iterations=4)["data"]
    rx_p = cdd_channel(fused._tx_cdd_plain(cfg_c, flat).reshape(Bc, 2, 2, -1), 28.0, 10)
    sym_p = fused._rx_receiver_plain(cfg_c, rx_p.reshape(Bc, -1), 4, "conv")[1]
    idx = fused._kernel_consts(cfg_c, dev)["demap_idx"]
    n = cfg_c.block_len
    d_p = torch.stack([sym_p[:, :n][:, idx], sym_p[:, n:][:, idx]], dim=1)
    wrong_k = int((torch.sign(d_k) != torch.sign(data)).sum())
    wrong_p = int((torch.sign(d_p) != torch.sign(data)).sum())
    print(f"[9 main] CDD link B={Bc} shifts=(0,2) taps of examples/cdd_two_antenna.py "
          f"launches={{tx_cdd: {run['tx_cdd']}, rx: {run['rx']}}} | 34 dB "
          + check("symbol_errors", float(wrong34), 0.0)
          + f" | 28 dB symbol errors kernels {wrong_k} plain {wrong_p} of "
          f"{data.numel()} " + check("|d_errors|", float(abs(wrong_k - wrong_p)),
                                     0.01 * wrong_p + 2), flush=True)
    del d34, rx_k, d_k, rx_p, sym_p, d_p


def _chain_phase(torch, dev, failures) -> None:
    """Phase 10: one chain step of the link's GEMM chain in each of f32,
    bf16 and int8, on benchmarks/int8_gauss.py's inputs."""
    from gfdm_tpu_torch.benchmarks import int8_gauss as bench
    from gfdm_tpu_torch.kernels import chain

    weights, x_np, scales = bench.make_inputs(B_CHAIN, 2)
    x = torch.from_numpy(x_np).to(dev)
    cws = {v: chain.chain_weights_from_numpy(weights, v).to(dev) for v in chain.VARIANTS}
    reset_launches()
    torch.cuda.synchronize()
    outs = {v: bench.chain_step(x, scales[1], cws[v]) for v in chain.VARIANTS}
    torch.cuda.synchronize()
    run = read_launches()
    counts = {f"chain_{v}": run[f"chain_{v}"] for v in chain.VARIANTS}
    for v, got in outs.items():
        if counts[f"chain_{v}"] != chain._KERNELS[v]:
            failures.append(f"chain_{v}: {counts[f'chain_{v}']} launches on the main path, "
                            f"expected {chain._KERNELS[v]}")
        if tuple(got.shape) != (B_CHAIN, 1152) or not bool(torch.isfinite(got).all()):
            failures.append(f"chain_{v}: outputs shape {tuple(got.shape)} / not finite")
    print(f"[10 main] B={B_CHAIN} chain step in each mode: launches={counts}", flush=True)


def _launch_counts(torch, fn):
    """(kernels the device ran, kernel-launch API calls the host made) in one
    call of ``fn`` after a warm-up, from torch.profiler; None where the
    profiler records no device kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    kernels = sum(1 for ev in events if ev.device_type == DeviceType.CUDA)
    calls = sum(1 for ev in events if ev.device_type == DeviceType.CPU
                and ev.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                                "cuLaunchKernelEx"))
    return (kernels, calls) if kernels else None


def _coded_link(torch, cfg, dev, impl, payload, noise, delay, constellation="qpsk"):
    """The services link of phase 11 once, with the launch counters reset
    just before it and read just after: the coded payload framed by
    cli.payload_to_symbols(constellation, fec="conv"), StreamingTransmitter(
    cycle_samples = CHUNK_LEN).serve (one burst a cycle, the Tx kernel), the
    stream delayed by ``delay`` samples plus ``noise`` (AWGN),
    chunk_with_lookahead, then StreamingReceiver(engine="fused", fec="conv",
    constellation, batch_chunks=N_CHUNKS).serve under DETECT_IMPL ``impl``,
    with 4 IC passes at 64-QAM (the qam64 cell's). Returns (sink outputs,
    launches, bursts sent)."""
    from gfdm_tpu_torch.cli import payload_to_symbols
    from gfdm_tpu_torch.ops import planar_pipeline as pp
    from gfdm_tpu_torch.runtime.service import StreamingReceiver
    from gfdm_tpu_torch.runtime.stream import chunk_with_lookahead
    from gfdm_tpu_torch.runtime.transmit_service import StreamingTransmitter

    default_impl = pp.DETECT_IMPL
    pp.DETECT_IMPL = impl
    tx = StreamingTransmitter(cfg, cycle_samples=CHUNK_LEN, device=dev)
    opts = {"constellation": "qam64", "ic_iterations": 4} if constellation == "qam64" else {}
    rx = StreamingReceiver(cfg, chunk_len=CHUNK_LEN, batch_chunks=N_CHUNKS,
                           engine="fused", fec="conv", device=dev, **opts)
    halo = cfg.frame_len + cfg.cp_len
    reset_launches()
    torch.cuda.synchronize()
    syms, n_bursts = payload_to_symbols(cfg, payload, constellation, fec="conv")
    planar = np.stack([syms.real, syms.imag], axis=1).astype(np.float32)
    parts = []
    batches = iter([planar])
    tx.serve(lambda: next(batches, None), lambda out: parts.append(out["samples"]))
    sig = np.concatenate(parts, axis=-1)
    sig = np.concatenate([np.zeros((2, delay), np.float32), sig], axis=-1)
    sig = sig[:, : N_CHUNKS * CHUNK_LEN] + noise
    chunks = chunk_with_lookahead(torch.from_numpy(sig), CHUNK_LEN, halo)
    chunks = chunks.transpose(0, 1).contiguous().numpy()
    outs = []
    src = iter([(chunks, 0)])
    rx.serve(lambda: next(src, None), outs.append)
    torch.cuda.synchronize()
    run = read_launches()
    pp.DETECT_IMPL = default_impl
    return outs, run, n_bursts


def _coded_phase(torch, cfg, dev, streams, card, check, failures) -> None:
    """Phase 11: the coded modem through both services (see the module
    docstring)."""
    from gfdm_tpu_torch.cli import burst_capacity_bytes, payload_to_symbols
    from gfdm_tpu_torch.coding import viterbi_decode
    from gfdm_tpu_torch.eval.sensitivity import modem_sensitivity
    from gfdm_tpu_torch.kernels import fused
    from gfdm_tpu_torch.ops import planar_pipeline as pp
    from gfdm_tpu_torch.ops import softbits
    from gfdm_tpu_torch.runtime.service import StreamingReceiver
    from gfdm_tpu_torch.runtime.transmit_service import StreamingTransmitter
    from gfdm_tpu_torch.utils.framing import check_crc32, pack_bits

    torch.cuda.empty_cache()
    rng = np.random.default_rng(14)
    cap = burst_capacity_bytes(cfg, 2, "conv")
    payload = bytes(rng.integers(0, 256, N_CHUNKS * cap, dtype=np.uint8))
    delay = int(rng.integers(0, CHUNK_LEN - cfg.frame_len))  # each burst whole in its chunk
    # AWGN at CODED_SNR_DB over the bursts' per-sample power (of 64 of them)
    s0, _ = payload_to_symbols(cfg, payload[: 64 * cap], fec="conv")
    b0 = StreamingTransmitter(cfg, device=dev).step(
        np.stack([s0.real, s0.imag], axis=1).astype(np.float32))
    sigma = (float(np.mean(np.sum(b0**2, axis=1))) * 10 ** (-CODED_SNR_DB / 10) / 2) ** 0.5
    noise = (sigma * np.random.default_rng(15).standard_normal(
        (2, N_CHUNKS * CHUNK_LEN))).astype(np.float32)
    # one coded 64-QAM run at QAM64_SNR_DB (unit-energy maps: the same power)
    cap64 = burst_capacity_bytes(cfg, 6, "conv")
    links = {"qpsk": (cap, payload, noise, CODED_SNR_DB),
             "qam64": (cap64, bytes(rng.integers(0, 256, N_CHUNKS * cap64, dtype=np.uint8)),
                       noise * np.float32(10 ** ((CODED_SNR_DB - QAM64_SNR_DB) / 20)),
                       QAM64_SNR_DB)}
    kernel_of = {"pallas2": "detect_lean", "pallas": "detect_front"}
    results = {}
    for impl, qam in ((pp.DETECT_IMPL, "qpsk"), ("pallas2", "qpsk"), ("pallas", "qpsk"),
                      (pp.DETECT_IMPL, "qam64")):
        lcap, lpay, lnoise, snr_db = links[qam]
        outs, run, n_bursts = _coded_link(torch, cfg, dev, impl, lpay, lnoise, delay, qam)
        out = outs[0]
        name = impl if qam == "qpsk" else f"{impl},{qam}"
        ic = 4 if qam == "qam64" else 2
        found, bits = out["found"], out["bits"]
        ok = np.zeros(n_bursts, bool)
        same = True
        for i in range(n_bursts):
            if not found[i]:
                continue
            good, part = check_crc32(pack_bits(bits[i][: (lcap + 4) * 8]))
            ok[i] = good
            if good and part != lpay[i * lcap : (i + 1) * lcap]:
                same = False
        lag = out["start_abs"][found] - (delay + CHUNK_LEN * np.arange(n_bursts)[found])
        need = ["tx", "rx", "viterbi"] + ([kernel_of[impl]] if impl in kernel_of else [])
        for key in need:
            if run[key] < 1:
                failures.append(f"kernel {key} was not launched on the coded path ({name})")
        if run["tx"] != 1 or run["rx"] != fused.rx_launches(ic) or run["viterbi"] != len(outs):
            failures.append(f"coded path ({name}): launches {run}, expected tx 1, rx "
                            f"{fused.rx_launches(ic)} and one decoder launch a batch "
                            f"({len(outs)})")
        if not same:
            failures.append(f"coded path ({name}): a CRC-clean payload differs from the sent one")
        if len(set(lag.tolist())) > 1:
            failures.append(f"coded path ({name}): detections off the cycle grid {set(lag)}")
        if qam == "qpsk":
            results[impl] = out
        print(f"[11 main] services link DETECT_IMPL={impl}: StreamingTransmitter.serve "
              f"({n_bursts} coded {qam} bursts, cycle {CHUNK_LEN}) -> delay {delay} + AWGN "
              f"{snr_db} dB -> StreamingReceiver(fused, fec=conv, {qam}).serve: found="
              f"{int(found.sum())}/{n_bursts} crc_clean={int(ok.sum())}/{n_bursts} "
              f"payloads_equal={same} launches={{tx: {run['tx']}, rx: {run['rx']}, "
              f"detect_front: {run['detect_front']}, detect_lean: {run['detect_lean']}, "
              f"viterbi: {run['viterbi']}}} "
              + check(f"{name}:1-found", 1.0 - float(found.mean()), 1.0 - TOL["found_min"])
              + " " + check(f"{name}:1-crc", 1.0 - float(ok.mean()), 1.0 - TOL["crc_min"])
              + f" ({card})", flush=True)

    # 2. sensitivity at full width
    t0 = time.perf_counter()
    sens = modem_sensitivity(cfg, snr_db=(4.0, 10.0), bursts_per_point=N_CHUNKS, device=dev)
    dt = time.perf_counter() - t0
    fr, cr = sens["found_rate"], sens["crc_rate"]
    print(f"[11 sensitivity] modem_sensitivity(bursts_per_point={N_CHUNKS}, seed 0): "
          f"snr_db={sens['snr_db'].tolist()} found={fr.tolist()} crc={cr.tolist()} "
          f"info_ber={sens['info_ber'].tolist()} ({dt:.1f} s) "
          + " ".join([
              check("1-found@4", 1.0 - float(fr[0]), 1.0 - TOL["found_min"]),
              check("1-found@10", 1.0 - float(fr[1]), 1.0 - TOL["found_min"]),
              check("0.9-crc@4", 0.9 - float(cr[0]), 0.0),
              check("0.95-crc@10", 0.95 - float(cr[1]), 0.0),
              check("crc@4-crc@10", float(cr[0] - cr[1]), 0.0),
          ]) + f" ({card})", flush=True)

    # 3. the found slots' soft bits and decoded bits on the card against the
    # CPU (the QPSK links' codeword, T = 468)
    out = results[pp.DETECT_IMPL]
    n_info = out["bits"].shape[1]
    rx = StreamingReceiver(cfg, chunk_len=CHUNK_LEN, batch_chunks=N_CHUNKS, engine="fused",
                           fec="conv", device=dev)
    f = out["found"]
    data = torch.from_numpy(out["data"][f]).to(dev)
    snr = torch.from_numpy(out["snr_lin"][f]).to(dev)
    nv = 1.0 / torch.clamp_min(snr, 1e-6)
    llr_card = softbits.maxlog_llrs_planar(data, rx._fec_points, nv[:, None])
    llr_cpu = softbits.maxlog_llrs_planar(data.cpu(), rx._fec_points, nv[:, None].cpu())
    soft = _rel_excess(llr_card.cpu(), llr_cpu, 1e-5 * float(llr_cpu.abs().max()), 1e-5)
    llrs = llr_card.reshape(llr_card.shape[0], -1)[:, rx._fec_inv]
    dec_card = viterbi_decode(llrs, n_info).cpu()
    dec_cpu = viterbi_decode(llrs.cpu(), n_info)
    differ = float((dec_card != dec_cpu).any(dim=1).float().mean())
    svc = float((dec_card.numpy() != out["bits"][f]).any(axis=1).mean())
    print(f"[11 check] found slots' LLRs card vs CPU " + check("softbits(rel excess)", soft, 1.0)
          + f" decoded {int(f.sum())} slots: " + check("share_differing_card_vs_cpu", differ,
                                                       TOL["decode_differ"])
          + " " + check("service_bits_vs_recomputed", svc, 0.0), flush=True)
    del data, snr, llr_card, llr_cpu, llrs

    # 4. times: the coded and the uncoded step on the friendly stream
    chunks = torch.from_numpy(streams["friendly"][0]).to(dev)
    samples = N_CHUNKS * CHUNK_LEN
    rx_plain = StreamingReceiver(cfg, chunk_len=CHUNK_LEN, batch_chunks=N_CHUNKS,
                                 engine="fused", device=dev)
    rx._step(chunks)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rx._step(chunks)
    except RuntimeError as exc:
        failures.append(f"coded service step waits for the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    coded = rx._step(chunks)
    data, snr = coded["data"], coded["snr_lin"]
    u1, c1, c2, u2 = (time_ms(fn) for fn in (
        lambda: rx_plain._step(chunks), lambda: rx._step(chunks),
        lambda: rx._step(chunks), lambda: rx_plain._step(chunks)))
    coded_ms, plain_ms = (c1 + c2) / 2, (u1 + u2) / 2
    dec_ms = time_ms(lambda: rx._fec_decode(data, snr))
    n_coded = _launch_counts(torch, lambda: rx._step(chunks))
    n_plain = _launch_counts(torch, lambda: rx_plain._step(chunks))
    n_dec = _launch_counts(torch, lambda: rx._fec_decode(data, snr))
    print(f"[11 time] coded step {c1:.3f}/{c2:.3f} ms = {samples / (coded_ms / 1e3):.4e} "
          f"coded samples/s, uncoded step {u1:.3f}/{u2:.3f} ms = "
          f"{samples / (plain_ms / 1e3):.4e} samples/s; the decoder (LLRs + deinterleave + "
          f"Viterbi) {dec_ms:.3f} ms = {dec_ms / coded_ms:.1%} of the coded step "
          f"(DETECT_IMPL={pp.DETECT_IMPL}, {N_CHUNKS} chunks x {CHUNK_LEN}, friendly stream "
          f"seed 0, {card})", flush=True)
    fmt = lambda c: "not measured" if c is None else f"{c[0]} kernels, {c[1]} launch calls"  # noqa: E731
    print(f"[11 launches] coded step {fmt(n_coded)}; uncoded step {fmt(n_plain)}; decoder "
          f"alone {fmt(n_dec)} (torch.profiler, one step after a warm-up, {card})", flush=True)
    del chunks, coded, data, snr


class _Timed:
    """A ring or sink whose ``push`` / ``pull`` is timed on the host clock;
    ``keep`` also keeps every pushed block."""

    def __init__(self, inner, keep: bool = False):
        self.inner, self.seconds, self.kept = inner, 0.0, [] if keep else None

    def push(self, planar):
        t0 = time.perf_counter()
        self.inner.push(planar)
        self.seconds += time.perf_counter() - t0
        if self.kept is not None:
            self.kept.append(planar)

    def pull(self, n: int):
        t0 = time.perf_counter()
        got = self.inner.pull(n)
        self.seconds += time.perf_counter() - t0
        if self.kept is not None and got[0].shape[0]:
            self.kept.append(got[0])
        return got

    @property
    def dropped(self) -> int:
        return self.inner.dropped


class _PacedUdp:
    """UdpSink.push in slices of ``slice_samples``; after each slice, wait
    (up to LIVE_WAIT_S) until the ring's framing shows the ingest thread has
    pushed all but the last chunk of what was sent. A lost datagram is then
    a fault, not a race: the socket buffer never holds more than a slice
    and a chunk. (``UdpIngest.poll`` reports only at the end of the stream,
    so the ring's chunk count is the progress signal.)"""

    def __init__(self, sink, ring, slice_samples: int):
        self.sink, self.ring, self.slice = sink, ring, int(slice_samples)
        self.sent = 0
        self.push_s = self.wait_s = 0.0

    def push(self, planar):
        for i in range(0, planar.shape[-1], self.slice):
            part = planar[:, i : i + self.slice]
            t0 = time.perf_counter()
            self.sink.push(part)
            t1 = time.perf_counter()
            self.sent += part.shape[-1]
            need = max(0, (self.sent - self.ring.halo) // self.ring.chunk_len)
            while self.ring.available_chunks < need:
                if time.perf_counter() - t1 > LIVE_WAIT_S:
                    raise RuntimeError(f"UDP ingest stalled: {self.ring.available_chunks} of "
                                       f"{need} chunks after {self.sent} samples sent")
                time.sleep(2e-5)
            self.push_s += t1 - t0
            self.wait_s += time.perf_counter() - t1


def _live_rx(torch, cfg, dev, source):
    """StreamingReceiver(engine="fused", 256 / 1,024) .serve over ``source``
    under the caller's DETECT_IMPL: (receiver, sink outputs, wall s)."""
    from gfdm_tpu_torch.runtime.service import StreamingReceiver

    rx = StreamingReceiver(cfg, chunk_len=CHUNK_LEN, batch_chunks=LIVE_RX_BATCH,
                           max_batch_chunks=LIVE_RX_MAX, engine="fused", device=dev)
    outs = []
    t0 = time.perf_counter()
    rx.serve(source, outs.append)
    wall = time.perf_counter() - t0
    got = {k: np.concatenate([o[k] for o in outs]) for k in ("found", "start_abs", "data")}
    return rx, got, wall


def _live_checks(cfg, label, got, payload, cycle, launches, detect_key, check) -> str:
    """4,096 of 4,096 found on the cycle grid, every decision right, each
    kernel of the loop launched (tests/test_transmit_service.py:94-101)."""
    f = got["found"]
    order = np.argsort(got["start_abs"][f])
    n = int(f.sum())
    grid = np.arange(N_LIVE) * cycle + cfg.cp_len
    starts_off = (N_LIVE if n != N_LIVE
                  else int(np.count_nonzero(got["start_abs"][f][order] != grid)))
    wrong = (payload.size if n != N_LIVE else
             int(np.count_nonzero(np.sign(got["data"][f][order]) != np.sign(payload))))
    parts = [f"found={n}/{N_LIVE}", check(f"{label}:missed", float(N_LIVE - n), 0.0),
             check(f"{label}:starts_off_grid", float(starts_off), 0.0),
             check(f"{label}:wrong_decisions", float(wrong), 0.0)]
    for key in ("tx", detect_key, "rx"):
        parts.append(check(f"{label}:no_{key}_launch", float(launches[key] < 1), 0.0))
    return " ".join(parts) + f" launches={ {k: launches[k] for k in ('tx', detect_key, 'rx')} }"


def _live_device_ms(torch, tx, rx, payload_dev, chunks):
    """CUDA-event ms of the loop's device work, (Tx, receive): the Tx kernel
    over every batch, the receive step over every super-batch (one timed,
    scaled)."""
    tx_ms = time_ms(lambda: tx._tx(payload_dev)) * (N_LIVE // LIVE_TX_BATCH)
    t = torch.from_numpy(chunks).to(rx.device)
    return tx_ms, time_ms(lambda: rx._step(t)) * (N_LIVE / chunks.shape[0])


def _live_phase(torch, cfg, dev, streams, card, check, failures):
    """Phase 12: the live-ring modem and the complex chain (see the module
    docstring)."""
    from gfdm_tpu_torch import native
    from gfdm_tpu_torch.entry import planar_payload
    from gfdm_tpu_torch.ops import planar_pipeline as pp
    from gfdm_tpu_torch.runtime import channel, receiver, transmitter
    from gfdm_tpu_torch.runtime.transmit_service import StreamingTransmitter, UdpSink

    torch.cuda.empty_cache()
    halo = cfg.frame_len + cfg.cp_len
    payload = planar_payload(cfg, N_LIVE, seed=12)
    samples = N_LIVE * CHUNK_LEN
    capacity = samples + halo + CHUNK_LEN

    def batches():
        it = iter(range(0, N_LIVE, LIVE_TX_BATCH))
        return lambda: None if (i := next(it, None)) is None else payload[i : i + LIVE_TX_BATCH]

    # (a) the ring loopback, under "pallas2"
    ring = native.StreamBuffer(capacity=capacity, chunk_len=CHUNK_LEN, halo=halo)
    tx = StreamingTransmitter(cfg, batch_bursts=LIVE_TX_BATCH, device=dev)
    push = _Timed(ring, keep=True)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tx.serve(batches(), push)
    push.push(np.zeros((2, halo), np.float32))  # flush the tail chunk
    tx_wall = time.perf_counter() - t0
    pull = _Timed(ring, keep=True)
    default_impl = pp.DETECT_IMPL
    pp.DETECT_IMPL = "pallas2"
    rx, got, rx_wall = _live_rx(torch, cfg, dev, pull)
    launches = read_launches()
    line = _live_checks(cfg, "ring", got, payload, tx.cycle_samples, launches, "detect_lean",
                        check)
    if tx.cycle_samples != CHUNK_LEN or rx.stats.dropped_ring:
        failures.append(f"ring loopback: cycle {tx.cycle_samples}, dropped {rx.stats.dropped_ring}")
    print(f"[12 live] ring loopback B={N_LIVE} DETECT_IMPL=pallas2 {line} "
          f"dropped={rx.stats.dropped_ring}", flush=True)
    tx_ms, rx_ms = _live_device_ms(torch, tx, rx, torch.from_numpy(
        payload[:LIVE_TX_BATCH]).to(dev), pull.kept[0])
    pp.DETECT_IMPL = default_impl
    loop_s = tx_wall + rx_wall
    print(f"[12 time] ring loopback wall: Tx serve {tx_wall * 1e3:.1f} ms (of it the ring "
          f"push {push.seconds * 1e3:.1f}), Rx serve {rx_wall * 1e3:.1f} ms (of it the ring "
          f"pull {pull.seconds * 1e3:.1f}); live loop {samples / loop_s:.4e} samples/s; card: "
          f"Tx kernel {tx_ms:.3f} ms, receive steps {rx_ms:.3f} ms (CUDA events, "
          f"{N_LIVE // LIVE_RX_MAX} steps of {LIVE_RX_MAX} chunks), "
          + f"card share of the loop {(tx_ms + rx_ms) / (loop_s * 1e3):.2%} ({card})",
          flush=True)
    stream_blocks = push.kept
    del pull, rx, got

    # (c) push_sc16 into a ring against push of the converted samples
    raw = native.planar_to_sc16(np.concatenate(stream_blocks, axis=-1))
    rings = [native.StreamBuffer(capacity=capacity, chunk_len=CHUNK_LEN, halo=halo)
             for _ in range(2)]
    t0 = time.perf_counter()
    rings[0].push_sc16(raw)
    t1 = time.perf_counter()
    rings[1].push(native.sc16_to_planar(raw))
    t2 = time.perf_counter()
    (c0, b0), (c1, b1) = rings[0].pull(N_LIVE), rings[1].pull(N_LIVE)
    differ = float(np.count_nonzero(c0 != c1)) + float(b0 != b1) + abs(c0.shape[0] - N_LIVE)
    print(f"[12 check] push_sc16 vs push(sc16_to_planar) over {raw.size // 2} samples: "
          f"chunks={c0.shape[0]} " + check("values_differing", differ, 0.0)
          + f"; push_sc16 {(t1 - t0) * 1e3:.1f} ms, convert + push {(t2 - t1) * 1e3:.1f} ms "
          f"(host, {card})", flush=True)
    del raw, rings, c0, c1, stream_blocks

    # (b) the UDP loopback over a real socket, under "pallas"
    ring = native.StreamBuffer(capacity=capacity, chunk_len=CHUNK_LEN, halo=halo)
    ing = _udp_ingest(native, ring)
    try:
        with open("/proc/sys/net/core/rmem_default") as f:
            rmem = int(f.read())
    except OSError:
        rmem = 212992  # Linux's default
    spd = 4096
    slice_samples = spd * max(1, min(8, rmem // (8 * spd) - 1))
    tx = StreamingTransmitter(cfg, batch_bursts=LIVE_TX_BATCH, scale=0.5, device=dev)
    sink = UdpSink(ing.port, samples_per_datagram=spd)
    paced = _PacedUdp(sink, ring, slice_samples)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tx.serve(batches(), paced)
    paced.push(np.zeros((2, halo), np.float32))
    sink.close()
    deadline = time.perf_counter() + LIVE_WAIT_S
    while ing.running and time.perf_counter() < deadline:
        time.sleep(1e-4)
    if ing.running:  # the end-of-stream datagram was lost: end the thread
        failures.append("UDP ingest never saw the end-of-stream datagram")
        ing.stop()
    ingested = ing.finish()
    tx_wall = time.perf_counter() - t0
    pull = _Timed(ring)
    pp.DETECT_IMPL = "pallas"
    rx, got, rx_wall = _live_rx(torch, cfg, dev, pull)
    pp.DETECT_IMPL = default_impl
    launches = read_launches()
    line = _live_checks(cfg, "udp", got, payload, tx.cycle_samples, launches, "detect_front",
                        check)
    print(f"[12 live] UDP loopback B={N_LIVE} DETECT_IMPL=pallas {line} "
          + check("udp:ingested-(sent+halo)", abs(ingested - (tx.stats.samples + halo)), 0.0)
          + f" ingested={ingested} datagrams={sink.datagrams_sent} "
          f"slice={slice_samples} rmem_default={rmem} dropped={rx.stats.dropped_ring}",
          flush=True)
    if rx.stats.dropped_ring:
        failures.append(f"UDP loopback: dropped {rx.stats.dropped_ring}")
    loop_s = tx_wall + rx_wall
    print(f"[12 time] UDP loopback wall: Tx serve + ingest {tx_wall * 1e3:.1f} ms (of it the "
          f"sink's push, sc16 conversion + sendto, {paced.push_s * 1e3:.1f}, pacing waits on "
          f"the ingest thread {paced.wait_s * 1e3:.1f}), Rx serve {rx_wall * 1e3:.1f} ms (of "
          f"it the ring pull {pull.seconds * 1e3:.1f}); live loop {samples / loop_s:.4e} "
          f"samples/s ({card})", flush=True)
    del pull, rx, got, ring

    # (d) the complex chain on the card against the same call on the CPU
    x = streams["friendly"][0]
    s = (x[:, 0] + 1j * x[:, 1]).astype(np.complex64)
    s_dev = torch.from_numpy(s).to(dev)
    card_out = receiver.receive_stream(cfg, s_dev)
    cuda_ms = time_ms(lambda: receiver.receive_stream(cfg, s_dev), iters=3)
    t0 = time.perf_counter()
    cpu_out = receiver.receive_stream(cfg, s, device="cpu")
    cpu_s = time.perf_counter() - t0
    start_g = card_out["detection"]["start"].cpu().numpy()
    start_c = cpu_out["detection"]["start"].numpy()
    whole = start_c - cfg.cp_len + cfg.frame_len <= s.shape[-1]  # the burst whole in its chunk
    e_data = float(np.abs(card_out["data"].cpu().numpy()[whole] - cpu_out["data"].numpy()[whole]).max())
    e_snr = float(np.max(np.abs(card_out["snr_lin"].cpu().numpy()[whole] / cpu_out["snr_lin"].numpy()[whole] - 1)))
    print(f"[12 chain] receive_stream complex64 B={N_LIVE} T={s.shape[-1]} card vs CPU: "
          + check("starts_differing", float(np.count_nonzero(start_g != start_c)), 0.0) + " "
          + check(f"data[{int(whole.sum())} whole bursts]", e_data, LIVE_TOL["data"]) + " "
          + check("snr_rel", e_snr, LIVE_TOL["snr_rtol"])
          + f"; card {cuda_ms:.3f} ms (CUDA events), CPU {cpu_s * 1e3:.1f} ms ({card})",
          flush=True)
    del s_dev, card_out, cpu_out

    # ... and the simulated link of gfdm_tpu/cli.py:394-457: Tx -> shape ->
    # multipath -> AWGN at 15 dB -> receive_stream, the same noise and taps
    rng = np.random.default_rng(13)
    sym = ((rng.integers(0, 2, (N_LIVE, cfg.n_data_symbols)) * 2 - 1)
           + 1j * (rng.integers(0, 2, (N_LIVE, cfg.n_data_symbols)) * 2 - 1)) / np.sqrt(2.0)
    unit = torch.from_numpy((rng.standard_normal((N_LIVE, cfg.padded_frame_len))
                             + 1j * rng.standard_normal((N_LIVE, cfg.padded_frame_len))
                             ).astype(np.complex64))
    decisions, errors = {}, {}
    for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
        b = transmitter.transmit_bursts(cfg, sym, device=where)[:, 0]
        rxs = channel.awgn(unit, channel.multipath(transmitter.shape_bursts(cfg, b), SIM_TAPS),
                           SIM_SNR_DB)
        d = receiver.receive_stream(cfg, rxs)["data"].cpu().numpy()
        decisions[key] = np.sign(d.real) + 1j * np.sign(d.imag)
        errors[key] = int(np.count_nonzero(
            decisions[key] != np.sign(sym.real) + 1j * np.sign(sym.imag)))
    differ = float(np.count_nonzero(decisions["card"] != decisions["cpu"]))
    print(f"[12 chain] simulate B={N_LIVE} multipath {SIM_TAPS.tolist()} AWGN {SIM_SNR_DB} dB: "
          + check("decisions_differing_card_vs_cpu", differ, 0.0)
          + f" symbol errors card={errors['card']} cpu={errors['cpu']} of "
          f"{sym.size} ({card})", flush=True)


def _cli_cmd(args: list) -> list:
    """The command line of ``python -m gfdm_tpu_torch <args>`` (the card)."""
    return [sys.executable, "-m", "gfdm_tpu_torch", *args]


def _last_json(text: str):
    """The last line of ``text`` that is a JSON object, or None."""
    for ln in reversed(text.strip().splitlines()):
        if ln.startswith("{"):
            return json.loads(ln)
    return None


def _run_cli(args: list, cwd) -> tuple:
    """``python -m gfdm_tpu_torch <args>``: (exit code, the last JSON line
    of its stderr or None, host wall s, stderr)."""
    t0 = time.perf_counter()
    proc = subprocess.run(_cli_cmd(args), cwd=cwd, capture_output=True, text=True,
                          timeout=APP_CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    return proc.returncode, _last_json(proc.stderr), wall, proc.stderr


def _udp_socket_queue(port: int):
    """(bytes queued, datagrams dropped) of the UDP socket bound to
    127.0.0.1:``port``, from /proc/net/udp; None where it is not listed."""
    local = f"0100007F:{port:04X}"
    try:
        with open("/proc/net/udp") as f:
            rows = [ln.split() for ln in f.readlines()[1:]]
    except OSError:
        return None
    for row in rows:
        if row[1] == local:
            return int(row[4].split(":")[1], 16), int(row[-1])
    return None


def _send_sc16_when_bound(port: int, planar: np.ndarray, rate: float) -> tuple:
    """Wait until a receiver is bound to udp:``port`` (a connected socket
    sees ECONNREFUSED while nothing listens; 2-byte probes are below one
    sc16 sample and dropped), then send ``planar`` through UdpSink at about
    ``rate`` samples/s, each datagram held while the receiving socket's
    queue is over APP_UDP_QUEUE bytes (the loopback socket keeps its default
    buffer), and the empty end-of-stream datagram: (seconds sent, datagrams,
    the socket's drop count before the end-of-stream datagram or None where
    /proc/net/udp does not list it, seconds held)."""
    import socket

    from gfdm_tpu_torch.runtime.transmit_service import UdpSink

    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.connect(("127.0.0.1", port))
    deadline = time.monotonic() + APP_CLI_TIMEOUT_S
    try:
        while True:
            try:
                for _ in range(3):
                    probe.send(b"\x00\x00")
                    time.sleep(0.05)
                break
            except ConnectionRefusedError:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"nothing bound udp:{port} in {APP_CLI_TIMEOUT_S} s")
                time.sleep(0.05)
    finally:
        probe.close()
    sink = UdpSink(port, samples_per_datagram=APP_UDP_DATAGRAM)
    step = APP_UDP_DATAGRAM  # one datagram, then wait for its turn
    held = 0.0
    t0 = time.perf_counter()
    for i in range(0, planar.shape[-1], step):
        t_hold = time.perf_counter()
        while (q := _udp_socket_queue(port)) is not None and q[0] > APP_UDP_QUEUE:
            if time.perf_counter() - t_hold > LIVE_WAIT_S:
                raise RuntimeError(f"UDP receiver stalled: {q[0]} bytes queued on "
                                   f"udp:{port} for {LIVE_WAIT_S} s")
            time.sleep(1e-4)
        held += time.perf_counter() - t_hold
        sink.push(planar[:, i : i + step])
        wait = t0 + (i + step) / rate - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
    sent = time.perf_counter() - t0
    q = _udp_socket_queue(port)
    sink.close()
    return sent, sink.datagrams_sent, None if q is None else q[1], held


def _app_cli(torch, cfg, dev, work, card, check, failures) -> None:
    """Phase 13 (a) and (b): tx -> rx through files and rx over UDP, each
    command a ``python -m gfdm_tpu_torch`` process on the card."""
    from gfdm_tpu_torch import cli
    from gfdm_tpu_torch.runtime.receiver import receive_stream

    root = str(work.parent.parent)
    payload = np.random.default_rng(APP_SEED).integers(0, 256, APP_PAYLOAD,
                                                       dtype=np.uint8).tobytes()
    pin = work / "payload.bin"
    pin.write_bytes(payload)
    for name, fmt, constellation, fec in (("qpsk", "cf32", "qpsk", "none"),
                                          ("qam16+conv", "sc16", "qam16", "conv")):
        flags = ["--constellation", constellation, "--fec", fec, "--iq-format", fmt]
        iq, out = work / f"{name}.{fmt}", work / f"{name}.out"
        rc_t, tx_stats, tx_wall, err_t = _run_cli(
            ["tx", "--infile", str(pin), "--outfile", str(iq)] + flags, root)
        rc_r, rx_stats, rx_wall, err_r = _run_cli(
            ["rx", "--infile", str(iq), "--outfile", str(out)] + flags, root)
        if rc_t or rc_r or rx_stats is None:
            failures.append(f"cli {name}: tx rc {rc_t}, rx rc {rc_r}: {err_t[-400:]} "
                            f"{err_r[-400:]}")
            continue
        got = out.read_bytes()
        cap = cli.burst_capacity_bytes(cfg, cli._constellation(constellation)[1], fec)
        bursts = -(-APP_PAYLOAD // cap)
        equal = got[:APP_PAYLOAD] == payload and len(got) == bursts * cap
        if not equal:
            failures.append(f"cli {name}: the payload did not come back byte-equal")
        # the card time of rx_file's receive_stream on the same capture
        stream = cli._read_iq(str(iq), fmt)
        chunk = cfg.padded_frame_len
        s_dev = torch.from_numpy(stream[: stream.size // chunk * chunk].reshape(-1, chunk)
                                 ).to(dev)
        pts = cli._constellation(constellation)[0]
        ic = cli.default_ic_iterations(constellation)
        rs_ms = time_ms(lambda: receive_stream(cfg, s_dev, ic_iterations=ic,
                                                       constellation=pts), iters=3)
        print(f"[13 cli] {name} {fmt} payload={APP_PAYLOAD} B bursts={rx_stats['bursts']} "
              f"(framed {bursts}) samples={stream.size} payload_equal={equal} "
              + check(f"{name}:bursts-crc_ok", rx_stats["bursts"] - rx_stats["crc_ok"], 0.0)
              + " " + check(f"{name}:bursts-framed", abs(rx_stats["bursts"] - bursts), 0.0)
              + f" snr_db_mean={rx_stats['snr_db_mean']}; host wall tx {tx_wall:.2f} s, "
              f"rx {rx_wall:.2f} s; card: rx_file's receive_stream {rs_ms:.3f} ms (CUDA "
              f"events, {s_dev.shape[0]} chunks) ({card})", flush=True)
        del s_dev, stream

    # (b) rx --udp-port fed the QPSK capture as sc16 datagrams
    stream = cli._read_iq(str(work / "qpsk.cf32"), "cf32")
    planar = np.stack([stream.real, stream.imag]).astype(np.float32)
    port = _free_udp_port()
    out = work / "udp.out"
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        _cli_cmd(["rx", "--udp-port", str(port), "--udp-timeout", str(APP_CLI_TIMEOUT_S),
                  "--outfile", str(out)]),
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        sent_s, datagrams, drops, held_s = _send_sc16_when_bound(port, planar,
                                                                 APP_UDP_RATE)
        _, err = proc.communicate(timeout=APP_CLI_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    wall = time.perf_counter() - t0
    stats = _last_json(err)
    captured = [int(w) for ln in err.splitlines() if ln.startswith("captured ")
                for w in ln.split()[1:2]]
    equal = out.exists() and out.read_bytes()[:APP_PAYLOAD] == payload
    if proc.returncode or not equal or drops:
        failures.append(f"cli rx --udp-port: rc {proc.returncode}, payload_equal={equal}, "
                        f"socket drops {drops}: {err[-400:]}")
    print(f"[13 cli] rx --udp-port: {planar.shape[-1]} samples in {datagrams} sc16 "
          f"datagrams over {sent_s:.2f} s (held {held_s:.3f} s on the receiver's queue), "
          f"socket drops={drops} captured={captured} payload_equal={equal} "
          f"rc={proc.returncode} stats={stats}; host wall {wall:.2f} s ({card})", flush=True)


def _free_udp_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _app_phase(torch, cfg, dev, card, check, failures):
    """Phase 13: the application layer (see the module docstring)."""
    import shutil
    import tempfile
    from pathlib import Path

    from gfdm_tpu_torch import blocks, cli
    from gfdm_tpu_torch.eval import ber, coded, spectrum
    from gfdm_tpu_torch.ops import legacy

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    (root / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_app_", dir=root / "build"))
    try:
        _app_cli(torch, cfg, dev, work, card, check, failures)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    reset_launches()

    # (c) simulate at tests/test_cli.py's settings, 4,096 bursts
    sims = {}
    for key, kw in (("20dB", dict(snr_db=20.0, ic_iterations=2, seed=1)),
                    ("12dB", dict(snr_db=12.0, ic_iterations=2, seed=1)),
                    ("4dB_conv", dict(snr_db=4.0, fec="conv", seed=3)),
                    ("4dB", dict(snr_db=4.0, seed=3))):
        t0 = time.perf_counter()
        sims[key] = cli.simulate(cfg, n_bursts=APP_BURSTS, device=dev, **kw)
        sims[key]["host_s"] = round(time.perf_counter() - t0, 3)
    n = APP_BURSTS
    print(f"[13 simulate] B={n} multipath {cli.SIM_TAPS.tolist()}: "
          + check("20dB:bursts-crc_ok", n - sims["20dB"]["crc_ok"], 0.0) + " "
          + check("20dB:payload_not_intact", float(not sims["20dB"]["payload_intact"]), 0.0)
          + " " + check("|est_20-est_12-8|", abs(sims["20dB"]["snr_db_est"]
                                                   - sims["12dB"]["snr_db_est"] - 8.0), 1.0)
          + " " + check("4dB_conv:1-crc_share", 1 - sims["4dB_conv"]["crc_ok"] / n,
                        1 - APP_CODED_CRC_MIN)
          + " " + check("4dB_uncoded:crc_ok", sims["4dB"]["crc_ok"], n // 2 - 1)
          + f" | {json.dumps(sims)} ({card})", flush=True)
    if sims["4dB_conv"]["residual_bit_errors"]:
        failures.append("simulate 4 dB conv: a CRC-clean burst carried bit errors")

    # (d) ber_sweep at examples/ber_sweep.py's grids
    sweeps = [("qpsk", np.arange(0, 22, 3, dtype=float), 2),
              ("qam16", np.arange(6, 28, 3, dtype=float), 2),
              ("qam64", np.arange(12, 34, 3, dtype=float), 4)]
    for name, snrs, ic in sweeps:
        t0 = time.perf_counter()
        res = ber.ber_sweep(cfg, snrs, bursts_per_point=APP_BURSTS, ic_iterations=ic,
                            constellation=name, device=dev)
        host_s = time.perf_counter() - t0
        ok = bool(np.all(np.isfinite(res["evm"])) and res["ber"][0] > res["ber"][-1])
        if not ok:
            failures.append(f"ber_sweep {name}: not finite or not falling over SNR")
        order = {"qpsk": 2, "qam16": 4, "qam64": 6}[name]
        n_bits = APP_BER_CMP * cfg.n_data_symbols * order
        cmp = {k: ber.ber_sweep(cfg, snrs, bursts_per_point=APP_BER_CMP, ic_iterations=ic,
                                constellation=name, device=d)
               for k, d in (("card", dev), ("cpu", "cpu"))}
        d_err = float(np.max(np.abs(cmp["card"]["ber"] - cmp["cpu"]["ber"]) * n_bits))
        d_evm = float(np.max(np.abs(cmp["card"]["evm"] / cmp["cpu"]["evm"] - 1)))
        print(f"[13 ber] {name} ic={ic} B={APP_BURSTS}: snr_db={res['snr_db'].tolist()} "
              f"ber={res['ber'].tolist()} evm={res['evm'].round(5).tolist()} "
              f"snr_est_db={res['snr_est_db'].round(2).tolist()} host {host_s:.2f} s; card "
              f"vs CPU at B={APP_BER_CMP} ({n_bits} bits a point): "
              + check(f"{name}:bit_errors_differing", d_err, max(2.0, 1e-4 * n_bits)) + " "
              + check(f"{name}:evm_rel", d_evm, 1e-4) + f" ({card})", flush=True)
    one = ber._sweep_fn(cfg, 2, "qpsk", "zf", "awgn", 8, 0.0)
    gen = torch.Generator().manual_seed(0)
    bits = np.random.default_rng(0).integers(0, 2, (APP_BURSTS, cfg.n_data_symbols, 2))
    bits_dev = torch.from_numpy(bits).to(dev)
    noise = ber._unit_normal(gen, (APP_BURSTS, 2, cfg.frame_len), dev)
    point_ms = time_ms(lambda: one(9.0, bits_dev, noise), iters=5)
    print(f"[13 time] ber point qpsk B={APP_BURSTS} ({APP_BURSTS * cfg.frame_len} samples): "
          f"card {point_ms:.3f} ms (CUDA events, bits and noise on the card) ({card})",
          flush=True)

    # (e) coded_vs_uncoded at examples/coded_link.py's points
    ebn0 = [1.0, 2.0, 3.0, 4.0, 5.0]
    t0 = time.perf_counter()
    cvu = coded.coded_vs_uncoded(cfg, ebn0, bursts=APP_BURSTS, seed=1, device=dev)
    host_s = time.perf_counter() - t0
    worse = [e for e, c, u in zip(ebn0, cvu["coded_ber"], cvu["uncoded_ber"])
             if e >= 3.0 and c > u]
    llrs_fn, fn, n_info, perm = coded._coded_fn(cfg, 2, "zf", "awgn", 8)
    cb = coded.conv_encode(np.random.default_rng(1).integers(
        0, 2, (APP_BURSTS, n_info)).astype(np.uint8))[..., perm]
    cb_dev = torch.from_numpy(cb).to(dev)
    llrs = llrs_fn(3.0, cb_dev, noise)
    coded_ms = time_ms(lambda: fn(3.0, cb_dev, noise), iters=3)
    dec_ms = time_ms(lambda: coded.viterbi_decode(llrs, n_info), iters=3)
    print(f"[13 coded] B={APP_BURSTS} ebn0_db={ebn0} coded_ber={cvu['coded_ber'].tolist()} "
          f"uncoded_ber={cvu['uncoded_ber'].tolist()} "
          + check("points>=3dB_with_coded>uncoded", float(len(worse)), 0.0)
          + f" host {host_s:.2f} s; card: a coded point {coded_ms:.3f} ms, the decoder "
          f"{dec_ms:.3f} ms = {dec_ms / coded_ms:.1%} (CUDA events) ({card})", flush=True)
    del llrs, cb_dev

    # (f) the block flowgraph, card against CPU
    rng = np.random.default_rng(APP_SEED)
    sym = ((rng.integers(0, 2, (APP_BURSTS, cfg.n_data_symbols)) * 2 - 1)
           + 1j * (rng.integers(0, 2, (APP_BURSTS, cfg.n_data_symbols)) * 2 - 1)) / 2**0.5
    noise_c = torch.from_numpy((0.005 * (rng.standard_normal((APP_BURSTS, CHUNK_LEN))
                                         + 1j * rng.standard_normal((APP_BURSTS, CHUNK_LEN)))
                                ).astype(np.complex64))
    flow = {}
    for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        grid = blocks.resource_mapper_cc(cfg, device=where)(sym)
        b = blocks.transmitter_cc(cfg, device=where)(sym)[:, 0]
        s = b.new_zeros((APP_BURSTS, CHUNK_LEN))
        s[:, APP_OFFSET : APP_OFFSET + cfg.frame_len] = b
        s = s + noise_c.to(where)
        ext = blocks.extract_burst_cc(cfg, device=where)
        det = ext.sync(s)
        bursts = ext(s, det)
        chan, tags = blocks.channel_estimator_cc(cfg, device=where)(
            bursts[:, cfg.cp_len : cfg.cp_len + 2 * cfg.subcarriers])
        frames = bursts[:, cfg.preamble_len + cfg.cp_len :][:, : cfg.block_len]
        syms = blocks.advanced_receiver_sb_cc(cfg, device=where)(frames, channel=chan)
        data = blocks.resource_demapper_cc(cfg, device=where)(syms)
        flow[key] = [t.cpu() for t in (grid, b, det["start"], data, tags["snr_lin"])]
        flow[key].append(time.perf_counter() - t0)
    fc, fp = flow["card"], flow["cpu"]
    d = fc[3].numpy()
    wrong = int(np.count_nonzero(np.sign(d.real) != np.sign(sym.real))
                + np.count_nonzero(np.sign(d.imag) != np.sign(sym.imag)))
    print(f"[13 blocks] flowgraph B={APP_BURSTS} card vs CPU: "
          + check("grid", _max_abs(fc[0], fp[0]), TOL["tx"]) + " "
          + check("tx", _max_abs(fc[1], fp[1]), TOL["tx"]) + " "
          + check("starts_differing", float(torch.count_nonzero(fc[2] != fp[2])), 0.0) + " "
          + check("data", _max_abs(fc[3], fp[3]), LIVE_TOL["data"]) + " "
          + check("snr_rel", _max_rel(fc[4], fp[4]), LIVE_TOL["snr_rtol"]) + " "
          + check("wrong_decisions", float(wrong), 0.0)
          + f"; host card {fc[5]:.2f} s, CPU {fp[5]:.2f} s ({card})", flush=True)
    del flow, noise_c

    # (g) the legacy modulator, card against CPU
    grid = ((rng.standard_normal((APP_BURSTS, cfg.block_len))
             + 1j * rng.standard_normal((APP_BURSTS, cfg.block_len))) / 2**0.5
            ).astype(np.complex64)
    grid_dev = torch.from_numpy(grid).to(dev)
    parts = []
    for fft_len in (cfg.block_len, 1024):
        got = legacy.modulate_oversampled(cfg, grid_dev, fft_len).cpu()
        ref = legacy.modulate_oversampled(cfg, grid, fft_len, device="cpu")
        exact = torch.from_numpy(grid.astype(np.complex128) @ legacy._legacy_operator(
            cfg, fft_len).T)
        scale = float(exact.abs().max())  # ~29: the legacy taps are not normalized
        ms = time_ms(lambda: legacy.modulate_oversampled(cfg, grid_dev, fft_len))
        parts.append(f"fft_len={fft_len} max|y|={scale:.2f} "
                     + check("card_vs_cpu_rel", _max_abs(got, ref) / scale, TOL["tx"]) + " "
                     + check("card_vs_f64_rel", _max_abs(got.to(exact.dtype), exact) / scale,
                             TOL["tx"])
                     + f" cpu_vs_f64_rel={_max_abs(ref.to(exact.dtype), exact) / scale:.3e}"
                     f" card {ms:.3f} ms")
    print(f"[13 legacy] B={APP_BURSTS} card vs CPU and a float64 product, relative to the "
          f"largest output: " + " ".join(parts) + f" ({card})", flush=True)
    del grid_dev, got

    # (h) spectrum_study, card against CPU
    t0 = time.perf_counter()
    sp = {"card": spectrum.spectrum_study(cfg, n_bursts=APP_BURSTS, device=dev)}
    card_s = time.perf_counter() - t0
    sp["cpu"] = spectrum.spectrum_study(cfg, n_bursts=APP_BURSTS, device="cpu")
    rel = max(abs(sp["card"][w][k] / sp["cpu"][w][k] - 1)
              for w in sp["card"] for k in ("oob_attenuation_db", "papr_median_db"))
    ccdf = max(float(np.max(np.abs(sp["card"][w]["papr_ccdf"] - sp["cpu"][w]["papr_ccdf"])))
               for w in sp["card"])
    oob = {w: round(v["oob_attenuation_db"], 4) for w, v in sp["card"].items()}
    papr = {w: round(v["papr_median_db"], 4) for w, v in sp["card"].items()}
    ordered = oob["gfdm_frame"] > oob["gfdm_core"] > oob["ofdm"]
    if not ordered:
        failures.append(f"spectrum_study: OOB not gfdm_frame > gfdm_core > ofdm: {oob}")
    print(f"[13 spectrum] B={APP_BURSTS} oob_db={oob} papr_median_db={papr} "
          f"ordered={ordered} card vs CPU: " + check("rel", rel, 1e-6) + " "
          + check("ccdf", ccdf, 1e-6) + f"; host {card_s:.2f} s ({card})", flush=True)
    launches = {k: v for k, v in read_launches().items() if v}
    print(f"[13 main] the port's kernels launched by (c)-(h): {launches or 'none'} (the "
          f"complex chain and the planar torch-op link; the coded BER's decoder); phase 13 "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def _sp_service(torch, cfg, dev, chunks, card, check, failures) -> None:
    """Phase 14 (a): the sp = 2 service on a virtual mesh of the card twice
    against the sp = 1 service, under each DETECT_IMPL."""
    from gfdm_tpu_torch.kernels import fused
    from gfdm_tpu_torch.kernels.fused import receive_bursts_fused
    from gfdm_tpu_torch.ops import planar_pipeline as pp
    from gfdm_tpu_torch.parallel import make_mesh
    from gfdm_tpu_torch.runtime.service import ServiceStats, StreamingReceiver
    from gfdm_tpu_torch.utils.profiling import StageTimer

    sub, halo = CHUNK_LEN // SP_SHARDS, cfg.frame_len + cfg.cp_len
    mesh = make_mesh([dev] * SP_SHARDS, dp=1, sp=SP_SHARDS)
    dev_chunks = torch.from_numpy(chunks).to(dev)
    kernel_of = {"pallas2": "detect_lean", "pallas": "detect_front"}
    default_impl = pp.DETECT_IMPL
    kw = dict(chunk_len=CHUNK_LEN, batch_chunks=N_CHUNKS, engine="fused")
    for impl in ("twostage", "pallas2", "pallas"):
        pp.DETECT_IMPL = impl
        one = StreamingReceiver(cfg, device=dev, **kw)
        two = StreamingReceiver(cfg, sp_shards=SP_SHARDS, mesh=mesh, **kw)
        two._step(dev_chunks)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        o2 = two.step(chunks)
        run = read_launches()
        o1 = one.step(chunks)
        f1, f2 = o1["found"], o2["found"].reshape(N_CHUNKS, SP_SHARDS)
        start2 = o2["start"].reshape(N_CHUNKS, SP_SHARDS) + np.arange(SP_SHARDS) * sub
        data2 = o2["data"].reshape((N_CHUNKS, SP_SHARDS) + o2["data"].shape[1:])
        # each sp = 1 burst against the found sp = 2 slot nearest its start
        dist = np.where(f2, np.abs(start2 - o1["start"][:, None]), CHUNK_LEN)
        near = dist.argmin(axis=1)
        rows = np.arange(N_CHUNKS)
        matched = f1 & (dist[rows, near] <= cfg.subcarriers)
        exact = matched & (dist[rows, near] == 0)
        # a burst within K samples of a sub-chunk boundary: the left shard's
        # search limit may take the peak's shoulder (the start moves)
        boundary = (np.abs(o1["start"][:, None] - sub * np.arange(1, SP_SHARDS)[None, :])
                    .min(axis=1) <= cfg.subcarriers)
        d2, d1 = data2[rows, near][exact], o1["data"][exact]
        flipped = int((np.sign(d2) != np.sign(d1)).any(axis=(1, 2)).sum())
        d_err = float(np.abs(d2 - d1).max())
        missed = f1 & ~matched
        # found sp = 2 slots with no sp = 1 burst: a shard takes its window's
        # strongest CFAR-valid pick, which a burst's tail can pass (the JAX
        # package's sp service finds the same)
        extra = int(f2.sum() - matched.sum())
        differ = int(missed.sum()) + int((matched & ~exact).sum()) + extra
        need = ["rx"] + ([kernel_of[impl]] if impl in kernel_of else [])
        for key in need:
            if run[key] < 1:
                failures.append(f"kernel {key} was not launched on the sp service path ({impl})")
        if run["rx"] != fused.rx_launches(2):
            failures.append(f"sp service [{impl}]: {run['rx']} receiver launches a step, "
                            f"expected {fused.rx_launches(2)} (one receiver call)")
        if impl in kernel_of and run[kernel_of[impl]] != 1:
            failures.append(f"sp service [{impl}]: {run[kernel_of[impl]]} detection launches")
        ms2 = time_ms(lambda: two._step(dev_chunks))
        ms1 = time_ms(lambda: one._step(dev_chunks))
        print(f"[14 sp] DETECT_IMPL={impl}: sp=2 found={int(f2.sum())} sp=1 found="
              f"{int(f1.sum())} of {N_CHUNKS} chunks; matched={int(matched.sum())} "
              f"(start_abs equal {int(exact.sum())}, moved at a sub-chunk boundary "
              f"{int((matched & ~exact).sum())}) missed at a boundary={int(missed.sum())} "
              f"extra={extra} "
              + check("missed_off_boundary", float((missed & ~boundary).sum()), 0.0) + " "
              + check("moved_off_boundary", float((matched & ~exact & ~boundary).sum()), 0.0)
              + " " + check("decisions_differing", float(flipped), 0.0) + " "
              + check("differing_share", differ / N_CHUNKS, SP_DIFFER_SHARE) + " "
              + check("data_vs_sp1", d_err, TOL["data"])
              + f" | step sp=2 {ms2:.3f} ms vs sp=1 {ms1:.3f} ms ({N_CHUNKS * SP_SHARDS} "
              f"windows of {sub + halo} vs {N_CHUNKS} chunks of {CHUNK_LEN + halo}) launches="
              f"{{rx: {run['rx']}, detect_front: {run['detect_front']}, detect_lean: "
              f"{run['detect_lean']}}} ({card})", flush=True)

        # the step's stages on the card (CUDA events), three steps
        timer = StageTimer()
        for _ in range(3):
            with timer.stage("windows") as st:
                st.value = w = dev_chunks.unfold(-1, sub + halo, sub).transpose(1, 2).reshape(
                    -1, 2, sub + halo)
            with timer.stage("detect") as st:
                st.value = det = pp.detect_bursts_planar(cfg, w, search_limit=sub,
                                                         dtype_name=two.dtype_name)
            with timer.stage("extract") as st:
                st.value = b = pp.extract_bursts_planar(cfg, w, det, dtype_name=two.dtype_name)
            with timer.stage("refine") as st:
                st.value = b = pp.refine_cfo_planar(cfg, b)[0]
            with timer.stage("receive") as st:
                st.value = receive_bursts_fused(cfg, b.contiguous(), ic_iterations=2)
        rep = timer.report(samples_per_call={k: N_CHUNKS * CHUNK_LEN for k in timer.times})
        print(f"[14 stages] DETECT_IMPL={impl} sp=2 step ({card}):\n    "
              + rep.replace("\n", "\n    "), flush=True)
        del o1, o2, data2, d1, d2

        if impl == default_impl:  # serve(): super-batches through the same mesh
            srv = StreamingReceiver(cfg, chunk_len=CHUNK_LEN, batch_chunks=1024,
                                    engine="fused", sp_shards=SP_SHARDS, mesh=mesh)
            it = iter(range(0, N_CHUNKS, 1024))
            srv.serve(lambda: None if (i := next(it, None)) is None else
                      (chunks[i : i + 1024], i * CHUNK_LEN), lambda o: None, max_batches=1)
            srv.stats = ServiceStats()
            got = []
            it = iter(range(0, N_CHUNKS, 1024))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.serve(lambda: None if (i := next(it, None)) is None else
                      (chunks[i : i + 1024], i * CHUNK_LEN), got.append)
            dt = time.perf_counter() - t0
            s_found = np.concatenate([g["found"] for g in got])
            s_abs = np.concatenate([g["start_abs"] for g in got])
            ref_abs = two._slot_offsets(N_CHUNKS) + two.step(chunks)["start"]
            print(f"[14 serve] sp=2 batches={srv.stats.batches} chunks={srv.stats.chunks} "
                  f"found={srv.stats.bursts_found} host loop {dt * 1e3:.1f} ms = "
                  f"{N_CHUNKS * CHUNK_LEN / dt:.4e} samples/s "
                  + check("start_abs_vs_step", float((s_abs[s_found] != ref_abs[s_found]).sum()),
                          0.0)
                  + f" ({card})", flush=True)
    pp.DETECT_IMPL = default_impl


def _par_scenarios(cfg) -> dict:
    """tests/test_parallel.py's four streams (2 rows, 4 chunks), complex64."""
    from gfdm_tpu_torch.ops.tx import transmit
    from gfdm_tpu_torch.ref import utils

    def bursts(seed):
        data = np.stack([utils.random_qpsk(cfg.n_data_symbols, seed=seed + i)
                         for i in range(2)]).astype(np.complex64)
        return transmit(cfg, data, device="cpu")[:, 0].numpy()

    def noise(shape, seeds):
        return (0.01 * (np.random.default_rng(seeds[0]).standard_normal(shape)
                        + 1j * np.random.default_rng(seeds[1]).standard_normal(shape))
                ).astype(np.complex64)

    fl = cfg.frame_len
    straddle = np.zeros((2, 4 * 2048), np.complex64)
    straddle[:, 2 * 2048 - fl // 2 : 2 * 2048 - fl // 2 + fl] = bursts(7)
    owner = np.zeros((2, 4 * 2048), np.complex64)
    owner[:, 100 : 100 + fl] = bursts(11)
    dual = noise((2, 4 * 2048), (3, 4))
    dual[:, 2 * 2048 + 150 : 2 * 2048 + 150 + fl] += bursts(31)
    dense = noise((2, 4 * 4096), (5, 6))
    for off, seed in ((4096 + 100, 41), (4096 + 100 + fl + 400, 43)):
        dense[:, off : off + fl] += bursts(seed)
    return {"straddle": straddle, "owner": owner, "dual": dual, "dense": dense}


def _sharded_detection(torch, cfg, dev, card, check) -> None:
    """Phase 14 (b): detect_bursts_sharded on a virtual card mesh against
    the same call on the CPU."""
    from gfdm_tpu_torch.parallel import detect_bursts_sharded, make_mesh

    meshes = {"card": make_mesh([dev] * (PAR_DP * PAR_SP), dp=PAR_DP, sp=PAR_SP),
              "cpu": make_mesh(["cpu"] * (PAR_DP * PAR_SP), dp=PAR_DP, sp=PAR_SP)}
    worst = {"start_owned_found_differ": 0.0, "found_cfo_apart": 0.0, "cfo_found": 0.0,
             "bursts_rel": 0.0}
    for name, stream in _par_scenarios(cfg).items():
        for planar in (False, True):
            x = np.stack([stream.real, stream.imag], 1).astype(np.float32) if planar else stream
            for k in (1, 2):
                runs = {where: detect_bursts_sharded(
                    cfg, mesh, torch.from_numpy(x).to(mesh.devices[0, 0]),
                    halo=cfg.frame_len + 64, planar=planar, max_bursts_per_chunk=k)
                    for where, mesh in meshes.items()}
                (dc, bc), (dr, br) = runs["card"], runs["cpu"]
                dc = {key: v.cpu().numpy() for key, v in dc.items()}
                dr = {key: v.numpy() for key, v in dr.items()}
                f = dr["found"]
                same = np.abs(dc["cfo"] - dr["cfo"]) <= PAR_TOL["cfo"]
                worst["start_owned_found_differ"] += sum(
                    int((dc[key] != dr[key]).sum()) for key in ("start", "owned", "found"))
                worst["found_cfo_apart"] += float((f & ~same).sum())
                if f.any():
                    worst["cfo_found"] = max(worst["cfo_found"],
                                             float(np.abs(dc["cfo"] - dr["cfo"])[f].max()))
                worst["bursts_rel"] = max(worst["bursts_rel"], float(
                    np.abs(bc.cpu().numpy()[same] - br.numpy()[same]).max()
                    / np.abs(br.numpy()).max()))
    limits = {"start_owned_found_differ": 0.0, "found_cfo_apart": 0.0,
              "cfo_found": PAR_TOL["cfo"], "bursts_rel": PAR_TOL["bursts"]}
    print(f"[14 sharded] detect_bursts_sharded on {PAR_DP}x{PAR_SP} copies of the card vs "
          f"the CPU, 4 scenarios x complex/planar x k=1,2 (sums and maxima): "
          + " ".join(check(key, v, limits[key]) for key, v in worst.items())
          + f" ({card})", flush=True)


def _parallel_examples(torch, cfg, dev, root, card, check, failures) -> None:
    """Phase 14 (e): the seven examples of the parallel slice on the card."""
    import shutil

    from gfdm_tpu_torch.entry import dryrun_multihost
    from gfdm_tpu_torch.examples import (cdd_two_antenna, coded_service, full_duplex_udp,
                                         large_k_link, stream_receiver, streaming_service)

    runs = (
        ("cdd_two_antenna", lambda: cdd_two_antenna.main(device=dev), ()),
        ("coded_service", lambda: coded_service.main(device=dev), ("rx",)),
        ("full_duplex_udp", lambda: full_duplex_udp.main(port=_free_udp_port(), device=dev),
         ("tx",)),
        ("large_k_link", lambda: large_k_link.main(device=dev),
         ("tx_factored", "rx_factored_chan")),
        ("stream_receiver", lambda: stream_receiver.main(device=dev), ()),
        ("streaming_service", lambda: streaming_service.main(device=dev), ()),
    )
    res = {}
    for name, fn, kernels in runs:
        reset_launches()
        t0 = time.perf_counter()
        try:
            res[name] = fn()
        except RuntimeError as exc:  # the example's own check
            failures.append(f"example {name}: {exc}")
            continue
        wall = time.perf_counter() - t0
        run = read_launches()
        for key in kernels:
            if run[key] < 1:
                failures.append(f"kernel {key} was not launched by example {name}")
        print(f"[14 example] {name}: {json.dumps(res[name], default=str)} launches="
              f"{ {k: run[k] for k in kernels} } host {wall:.2f} s ({card})", flush=True)
    parts = []
    if "cdd_two_antenna" in res:
        got = res["cdd_two_antenna"]
        parts.append(check("cdd:symbol_error_share", got["symbol_errors"] / got["symbols"],
                           cdd_two_antenna.SYMBOL_ERROR_FLOOR))
    if "coded_service" in res:
        got = res["coded_service"]
        parts += [check("coded:not_crc_clean", float(got["bursts"] - got["crc_clean"]), 0.0),
                  check("coded:payload_damaged", float(not got["intact"]), 0.0)]
    if "full_duplex_udp" in res:
        got = res["full_duplex_udp"]
        parts += [check("udp:missed", float(got["bursts"] - got["found"]), 0.0),
                  check("udp:decision_evm", got["evm"], 0.0)]
    if "large_k_link" in res:
        parts.append(check("large_k:evm", res["large_k_link"]["evm"], 1e-5))
    if "stream_receiver" in res:
        got = res["stream_receiver"]
        parts += [check("stream:missed", float(got["pulled"] - got["found"]), 0.0),
                  check("stream:evm", got["evm"], 1e-5)]
    if "streaming_service" in res:
        got = res["streaming_service"]
        parts += [check("service:symbol_errors", float(got["symbol_errors"]), 0.0),
                  check("service:starts_differ", float(got["starts"] != got["expected_starts"]),
                        0.0),
                  check("service:missed", float(got["bursts"] - got["found"]), 0.0)]
    print("[14 example] checks " + " ".join(parts), flush=True)

    # the dry runs that spawn their own processes
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gfdm_tpu_torch.examples.multichip_sharding",
                           "--device", dev.type], cwd=root, capture_output=True, text=True,
                          timeout=PAR_TIMEOUT_S)
    line = (proc.stdout.strip().splitlines() or [""])[-1]
    if proc.returncode != 0 or "sp_serve_found=4" not in line:
        failures.append(f"multichip_sharding rc={proc.returncode}: {line} "
                        f"{proc.stderr[-800:]}")
    print(f"[14 example] multichip_sharding (own process, {time.perf_counter() - t0:.1f} s): "
          f"{line} ({card})", flush=True)
    reset_launches()
    t0 = time.perf_counter()
    r = dryrun_multihost(PAR_PROCS, device=dev)
    shutil.rmtree(r.pop("out_dir"), ignore_errors=True)
    print(f"[14 example] dryrun_multihost ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(r)} (one card shared by {PAR_PROCS} processes, {card})", flush=True)


def _parallel_phase(torch, cfg, dev, streams, card, check, failures) -> None:
    """Phase 14: the parallel layer (see the module docstring)."""
    import shutil
    import tempfile
    from pathlib import Path

    from gfdm_tpu_torch.entry import dryrun_multichip
    from gfdm_tpu_torch.parallel.multihost import build_stream_chunks, launch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    # (a) the sp service at full width
    _sp_service(torch, cfg, dev, streams["friendly"][0], card, check, failures)
    # (b) the sharded detection on a virtual card mesh vs the CPU
    _sharded_detection(torch, cfg, dev, card, check)
    # (c) the eight-device dry run on the card
    reset_launches()
    res = dryrun_multichip(PAR_DP * PAR_SP, device=dev)
    run = read_launches()
    if run["rx"] < 1:
        failures.append("dryrun_multichip launched no receiver kernel")
    print(f"[14 dryrun] multichip {res} launches={{rx: {run['rx']}}} "
          + check("evm", res["evm"], TOL["evm_max"]) + " "
          + check("sp_serve_found!=dp", float(res["sp_serve_found"] != res["dp"]), 0.0)
          + f" ({card})", flush=True)
    # (d) two processes on the one card, one gloo group
    (root / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_par_", dir=root / "build"))
    try:
        t0 = time.perf_counter()
        r = launch(PAR_PROCS, n_chunks=PAR_CHUNKS, out_dir=str(work), timeout=PAR_TIMEOUT_S,
                   device=dev.type, batch_chunks=PAR_BATCH)
        wall = time.perf_counter() - t0
        found = np.concatenate([np.load(work / f"n{PAR_PROCS}" / f"proc{i}.npz")["found"]
                                for i in range(PAR_PROCS)])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    expect = build_stream_chunks(cfg, PAR_CHUNKS, device=dev)[2]
    print(f"[14 multihost] {PAR_PROCS} processes x {PAR_CHUNKS // PAR_PROCS} chunks (batch "
          f"{PAR_BATCH}, xla engine): bursts={r['bursts_found']} (sent {int(expect.sum())}; "
          f"false alarms in empty chunks at {np.flatnonzero(found & ~expect).tolist()}) "
          + check("parity", float(not r["parity"]), 0.0) + " "
          + check("psum", float(not r["psum_ok"]), 0.0) + " "
          + check("missed", float((expect & ~found).sum()), 0.0) + " "
          + check("false_alarm_share", float((found & ~expect).mean()), PAR_FALSE_ALARM_SHARE)
          + f" serve {r['serve_seconds_multi_max'] * 1e3:.1f} ms/process vs "
          f"{r['serve_seconds_single'] * 1e3:.1f} ms one process, efficiency "
          f"{r['efficiency']:.3f} (one card shared: contention, not scaling); launch wall "
          f"{wall:.1f} s ({card})", flush=True)
    # (e) the seven examples
    _parallel_examples(torch, cfg, dev, root, card, check, failures)
    print(f"[14 wall] phase 14 {time.perf_counter() - t_phase:.1f} s ({card})", flush=True)


def _udp_ingest(native, ring, tries: int = 20):
    """native.UdpIngest on a free loopback port (the OS picks it)."""
    for _ in range(tries):
        try:
            return native.UdpIngest(_free_udp_port(), ring)
        except OSError:
            continue
    raise OSError(f"no free UDP port in {tries} tries")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from gfdm_tpu_torch import GfdmConfig
    from gfdm_tpu_torch.entry import entry, planar_payload, service_stream
    from gfdm_tpu_torch.kernels import cuda_lib, fused
    from gfdm_tpu_torch.ops.planar_pipeline import evm, link_step_planar

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    card = card_line()
    failures: list[str] = []

    def check(name: str, value: float, limit: float) -> str:
        ok = value <= limit  # False for NaN
        if not ok:
            failures.append(f"{name}={value!r} (limit {limit})")
        return f"{name}={value:.3e}{'' if ok else ' FAIL'}"

    # 1. device
    print(f"[1 device] {card} | {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    info = cuda_lib.build_info()
    print(f"[2 build] {info['seconds']:.1f} s nvcc, cached={info['cached']}, "
          f"{info['path']}", flush=True)
    for ln in ptxas_lines():
        print(f"    ptxas: {ln}")

    # 3. each kernel against its plain version at the main paths' shapes
    for c in kernel_checks(dev):
        print(f"[3 check] {c.label}: max_abs={c.err:.3e} "
              + " ".join(check(f"{c.key}:{n}", v, lim) for n, v, lim in c.parts), flush=True)
    torch.cuda.empty_cache()

    # 4. the main path at full batch, through the user's entry points
    cfg = GfdmConfig()
    data = torch.from_numpy(planar_payload(cfg, B, seed=0)).to(dev)
    flat = data.reshape(B, -1)
    step, (example,) = entry(dev)
    _d, _s, evm_example = step(example)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_hat, snr, evm_link = step(data)
    d_split, snr_split, evm_split = fused.link_step_fused(cfg, data)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = {key: fused.LAUNCHES[key] for key in ("tx", "rx", "link")}
    ref_link, _ = fused._link_single_plain(cfg, flat, 2, "matmul")
    evm_link_plain = float(evm(ref_link.reshape(data.shape), data))
    sym_plain = fused._rx_receiver_plain(
        cfg, fused._tx_frame_plain(cfg, flat, 0), 2, "conv")[1]
    idx = fused._kernel_consts(cfg, dev)["demap_idx"]
    split_plain = torch.stack([sym_plain[:, : cfg.block_len][:, idx],
                               sym_plain[:, cfg.block_len :][:, idx]], dim=1)
    evm_split_plain = float(evm(split_plain, data))
    evm_planar = float(link_step_planar(cfg, data)[2])
    evm_link, evm_split = float(evm_link), float(evm_split)
    finite = bool(torch.isfinite(d_hat).all() and torch.isfinite(d_split).all())
    shapes = tuple(d_hat.shape) == tuple(data.shape) == tuple(d_split.shape)
    if not (finite and shapes and snr.shape == (B,) and snr_split.shape == (B,)):
        failures.append(f"main path outputs: finite={finite} shapes={shapes}")
    for k, v in launches.items():
        if v < 1:
            failures.append(f"kernel {k} was not launched on the main path")
    if launches["link"] != fused.link_launches("matmul", 2):
        failures.append(f"link: {launches['link']} launches on the main path, expected "
                        f"{fused.link_launches('matmul', 2)} (one a stage)")
    if launches["rx"] != fused.rx_launches(2):
        failures.append(f"rx: {launches['rx']} launches on the main path, expected "
                        f"{fused.rx_launches(2)} (one a stage)")
    print(f"[4 main] B={B} ({B * cfg.frame_len / 1e6:.1f} M samples/step) "
          f"launches={launches} host {host_s * 1e3:.1f} ms | "
          + " ".join([
              f"evm_link={evm_link:.6f} plain={evm_link_plain:.6f}",
              check("|d|", abs(evm_link - evm_link_plain), TOL["evm"]),
              check("evm_link", evm_link, TOL["evm_max"]),
              f"| evm_split={evm_split:.6f} plain={evm_split_plain:.6f}",
              check("|d|", abs(evm_split - evm_split_plain), TOL["evm"]),
              check("|d_planar|", abs(evm_split - evm_planar), TOL["evm"]),
              check("evm_split", evm_split, TOL["evm_max"]),
              check("evm_entry64", float(evm_example), TOL["evm_max"]),
          ]), flush=True)
    del d_hat, d_split, ref_link, sym_plain, split_plain

    # 6. the streaming receive service
    streams = {
        name: service_stream(cfg, N_CHUNKS, CHUNK_LEN, 20.0, impaired,
                             np.random.default_rng(0))
        for name, impaired in (("friendly", False), ("impaired", True))
    }
    _service_phase(torch, cfg, dev, streams, card, check, failures)

    # 7. the large-K factored link
    _large_k_phase(torch, dev, check, failures)

    # 8. the service at qam16 / qam64
    _options_phase(torch, cfg, dev, card, check, failures)

    # 9. the CDD link
    _cdd_phase(torch, dev, data, check, failures)

    # 10. the link's GEMM chain at f32, bf16 and int8
    _chain_phase(torch, dev, failures)

    # 11. the coded modem through the transmit and receive services
    _coded_phase(torch, cfg, dev, streams, card, check, failures)

    # 12. the live-ring modem over the ring and a real socket, the complex chain
    _live_phase(torch, cfg, dev, streams, card, check, failures)

    # 13. the application layer: the CLI, simulate, the evaluation harnesses,
    # the block flowgraph and the legacy modulator
    _app_phase(torch, cfg, dev, card, check, failures)

    # 14. the parallel layer: the sp service, the sharded detection, the dry
    # runs, the multi-process serve and the last seven examples
    _parallel_phase(torch, cfg, dev, streams, card, check, failures)

    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
