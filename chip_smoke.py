#!/usr/bin/env python3
"""Run the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py    # canonical config: link B = 65,536 bursts,
                             # service 4,096 chunks x 2,048 samples

Phases, one line each (any failure exits non-zero and prints no result):

1. device  - requires CUDA; prints the card's name and power limit.
2. build   - compiles the CUDA kernels of gfdm_tpu_torch/csrc with nvcc.
3. check   - each kernel against its plain torch version on the same CUDA
             inputs: the Tx at a ragged batch (4,099) and shifts (0, 4), at
             the canonical config and at n_data = 130 (K = 32, 26 active,
             M = 5: an xi plane 520 bytes into a row), with its bit-equality
             printed, then at the full batch; the staged
             receiver on noisy bursts (AWGN 20 dB) and the staged link,
             both IC modes, at the full batch and a ragged one (4,099); both
             detection kernels on the service's 4,096 friendly chunks, on
             37 chunks of a T that is not 128-aligned and on
             entry._dynamic_range_chunks (power steps of 60 dB, an all-zero
             chunk, a burst after silence).
4. main    - the entry step (link_single_fused, matmul IC) and
             link_step_fused (Tx kernel -> the receiver's stages) at full
             batch, with the launch counters reset just before; EVM against
             the plain versions and the planar torch-op link.
5. time    - each link kernel and its plain version, CUDA events after
             warm-up; beside the Tx, a note with the time of its core's three
             products as torch.mm (TF32 off), the plain version's SGEMMs
             without the framing; the link's and the receiver's time a
             stage.
6. service - StreamingReceiver(engine="fused") on the synthetic service
             streams (entry.service_stream, seed 0): friendly (20 dB AWGN,
             one burst a chunk, k = 1) under DETECT_IMPL "pallas2" (lean
             detection kernel), "pallas" (front kernel) and "twostage"
             (torch ops); impaired (8-tap multipath, CFO up to +-0.2, 0-2
             bursts a chunk, k = 2) under "pallas" and "twostage". Each step
             runs once under torch's sync debug mode, which fails on any
             host sync inside it; then once with the launch counters reset
             just before, through StreamingReceiver.step: found fraction,
             device-step samples/s (CUDA events), the device's busy time a
             step and the receiver's part of it (torch.profiler), launches,
             and on the
             friendly stream the EVM of the found slots against the sent
             payload; then the detection kernels' times with a note of
             conv1d's (cuDNN, TF32 off) for their cross-correlation alone
             at the same shape, the receiver's time a stage at the
             service's 4,096 slots, and one serve() loop (batch 256,
             super-batch 1,024, pipeline depth 2).
7. large K - the factored kernels (entry.large_k_config, the crossover
             study's M = 9 configs): at K = 256, 512 (B = 4,096) and 1,024
             (B = 2,048) the Tx kernel and the receiver kernel with the
             channel read (estimator="fast"), at K = 128, B = 4,096 the
             receiver with its own dense estimator (two launches: the
             estimator GEMM, then the receiver kernel on its channel), each
             against its plain version on noisy bursts (AWGN 20 dB); the
             staged dense receiver and link at K = 128, 256 and 512
             (128-burst tiles). Then the large-K link link_step_factored
             (Tx kernel -> torch-op estimate -> receiver kernel -> demap) at
             K = 512, B = 4,096 and the estimator="fused" link at K = 128,
             each with the launch counters reset just before and read just
             after: hard decisions against the payload, EVM against the
             plain versions' and the torch-op method="fast" chain's. Last,
             kernel vs plain (with the bound counting the K-point stage as
             an FFT, the direct DFT's beside it) and the link (kernels,
             plain versions, torch-op chain) timed at those K, the
             estimator="fused" receiver (both launches) at K = 128 and its
             estimator GEMM alone (beside torch.mm of the same product, TF32
             off, and its error against a float64 product); a note with
             torch.fft.fft's (cuFFT)
             time for the K-point stage alone; the link's device time a
             stage (Tx, torch-op estimate, receiver, demap and EVM) at K =
             512 and 1,024.

8. options - the receiver's stages against their plain version (summed in
             float64, as the stages sum) at B = 16,384
             noisy bursts for each option combination the JAX package's
             tests cover: (mmse, qpsk), (mmse_cnr, qpsk), (mmse_cnr, qam16),
             (mmse, qam64), phase compensation on a 0.1 rad rotation of the
             data section, qam16 under the matmul IC. Bursts whose IC
             decisions differ between kernel and plain version (a decision
             within float rounding of a level boundary; found by running
             both at 0 and 1 IC iterations) are counted and left out of the
             max-abs check; beside that count, the same count against the
             float32 plain version (printed, no limit); the receiver's
             launches (the phase stage included) and each product stage
             against the plain stage on its own inputs under each equalizer.
             The link kernel at qam16,
             qam64 and bf16 stacks.
             Then, with the launch counters reset just before, the service
             (fused engine vs the torch-op xla engine) on 4,096-chunk qam16
             (mmse_cnr, 30 dB) and qam64 (mmse, 36 dB) streams.
9. cdd, variants - tx_cdd_fused against its plain version at B = 65,536
             with shifts (0, 2) and at a ragged B with (0, 3, 7), with its
             bit-equality printed; with the
             counters reset, the two-antenna CDD link (entry.cdd_link: the
             example's taps) at 34 dB, no symbol error allowed, and at 28 dB
             beside its plain version; each superseded receiver (rx_core,
             rx_ic, rx_full, rx_hybrid; IC at 2 iterations) against its
             plain version at B = 65,536, called once with the counters
             reset, each with exactly fused.variant_launches launches; the
             device time of each of their stages (CUDA events around each
             launch); rx_core's two Gauss products as six torch.mm (TF32
             off), the yardstick of a part; then kernel and plain times of
             the CDD Tx and the four receivers.
10. chain  - the link's GEMM chain (benchmarks/int8_gauss.py's shapes,
             (B, 936) -> 1152 -> 1152 -> 1152) at B = 65,536 with the
             benchmark's inputs (gfdm_tpu_torch.benchmarks.int8_gauss): with
             the launch counters reset just before, one chain step in each
             of f32, bf16 and int8; each against its plain version (f32
             max |d| / max |ref| <= 1e-5, bf16 <= 1e-2, int8 bit for bit)
             and against a float64 chain; then kernel, plain and library
             times (three torch.mm with TF32 off; three torch.mm with
             float32 output; torch._int_mm with torch-op quantization
             between); the int8 call's device time a launch (x's pass,
             three stages) and the clusters its stages run as; torch._int_mm
             x3 on operands quantized beforehand (the GEMMs alone); and
             torch.linalg.multi_dot's time as a note (it reassociates: not
             the chain's function).
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
             clean payloads equal to those sent; and once more as coded
             64-QAM (constellation="qam64", 4 IC passes, 25 dB; T = 1,404)
             under the default DETECT_IMPL. The kernels JSON's Viterbi rows
             take their launches from these runs at the default
             DETECT_IMPL (T = 468 and 1,404). Then
             eval.sensitivity.modem_sensitivity at 4,096 bursts a point (4
             and 10 dB: found >= 0.999, CRC >= 0.9 / 0.95, not lower at 10
             dB); the Viterbi decoder card against CPU in every mode on
             dyadic LLRs (bit for bit) and on the found slots' real LLRs (the
             share of slots differing, <= 1e-3), the soft bits card against
             CPU (1e-5 relative); the coded and the uncoded service step
             (CUDA events, friendly stream, default DETECT_IMPL), the
             decoder alone and its share, their launches (torch.profiler),
             the decoder's parts (the Viterbi kernel beside its plain
             version's on the card) and StreamingTransmitter.step at 4,096
             bursts. Last, the Viterbi kernel alone at 4,096 codewords of T
             = 468 and 1,404 (radix 16) on noisy LLRs: no row differing from
             the plain version on the CPU, kernel and plain times (the
             torch-op decoder on the card) in turns.
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
             receive); both detection kernels against their plain versions
             on the 8,192 sub-chunk windows (1,024 + 768 samples, n_valid
             1,024). (b) parallel.detect_bursts_sharded on eight copies of
             the card (dp = 2, sp = 4) at tests/test_parallel.py's four
             scenarios, complex and planar, k = 1 and 2, against the same
             call on the CPU. (c) entry.dryrun_multichip(8) on the card.
             (d) parallel.multihost.launch: two processes sharing the card
             in one gloo group, 4,096 chunks, against one process (parity,
             the metrics' all-reduce, the bursts expected). (e) the seven
             examples of the slice on the card, each with its own check
             (multichip_sharding in its own process, dryrun_multihost
             spawning its workers), the kernels each should launch.

Then a JSON line of per-kernel results (launches on the main paths, error
against the plain version, kernel, plain and library ms, the bound: the
larger of the operations over the card's peak for their type - 67 TFLOP/s
of fp32 FMA, 495 TFLOP/s of dense TF32 (three products a float32-stack
product in the staged link and receiver), 67 TFLOP/s of FP64 tensor cores
(the bf16 link's float64 sums; the receiver's beside its bound), 989
TFLOP/s of dense bf16, 1,979 TOP/s of dense
int8 - and the bytes, each input read once and each output
written once, over 3.35 TB/s, at the timed shapes), the card line, and as
the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

B = 65536  # bursts per main-path step: 49 M samples at the canonical config
TOL = {
    # float32 products summed in another order: bursts ~1e-6, and the
    # receiver's ZF divide and IC amplify that by < 100
    "tx": 2e-5,
    "chan": 2e-4,
    "symbols": 5e-4,
    "data": 1e-4,
    "snr_rtol": 1e-3,
    "cnr_rtol": 1e-2,
    "evm": 1e-4,
    "evm_max": 0.025,  # the clean-loopback floor is 0.018 (JAX on CPU)
    # detection kernels vs plain: the JAX package's Pallas-vs-reference
    # limits for traces (tests/test_detection.py), peak fields as in
    # tests/test_torch_detect.py
    "trace_atol": 3e-5, "trace_rtol": 3e-3,
    "peak_atol": 1e-6, "peak_rtol": 1e-4,
    # service: found fraction floor, kernel paths vs the torch-op twostage
    "found_min": 0.999, "found_vs_twostage": 1e-3, "evm_vs_twostage": 1e-3,
    # options: the share of bursts whose IC decisions differ between kernel
    # and plain version (each must start from a decision within 1e-5 of a
    # level boundary: float rounding, not a fault; qam64 measured 2.4e-4 at
    # 20 dB and on the clean link, so 1e-3); the service's fused vs xla
    # engines on found slots whose last IC decisions agree, and the share
    # that differ
    "excluded_share": 1e-3, "boundary": 1e-5, "engines_data": 2e-3,
    "engines_flipped_share": 1e-2,
    # bf16 stacks: float32 sums in another order can leave an activation on
    # the other side of a bf16 rounding boundary, which moves its burst's
    # outputs by up to ~5e-3 (CPU: the plain version against JAX's)
    "bf16_data": 1e-2,
    # ... and so moves a decision up to ~2e-2 level units from a boundary to
    # the other side, in a burst of a few hundred (the CPU's one in eight
    # bursts of JAX vs plain); those bursts are left out, at most 2%
    "bf16_boundary": 2e-2, "bf16_excluded_share": 2e-2,
    # the bf16 link kernels sum the products whose outputs are rounded to
    # bf16 next (Tx, estimate) in float64, so they are held to the plain
    # version summed in float64 (sum64); besides, each product stage against
    # the plain stage on the kernel's own inputs, relative to the stage's
    # largest magnitude
    "stages": 1e-5,
    # row 6's estimator GEMM against a float64 product, relative to its
    # largest output: float32 sums over 4K = 512 terms in order (~1e-6)
    "estimate64": 1e-5,
    # phase 11, the coded services link at CODED_SNR_DB: the share of sent
    # bursts whose CRC-clean payload comes back; the share of found slots
    # whose decoded bits differ between the card and the CPU on the same
    # LLRs (equal branch sums, so only an argmax over a float tie could)
    "crc_min": 0.99, "decode_differ": 1e-3,
}
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12  # H100 SXM: fp32 FMA (no TF32), HBM3
# H100 SXM dense tensor cores (NVIDIA's data sheet; FP64 tensor cores 67 TFLOP/s)
PEAK_TF32, PEAK_BF16, PEAK_FP64_TC = 495e12, 989e12, 67e12
# the chain modes' operations run at their own dense peaks (H100 SXM)
# the Viterbi kernel's adds and compares: one a fp32 lane a clock, half the FMA peak
PEAK_OPS = {"chain_bf16": PEAK_BF16, "chain_int8": 1979e12,
            "viterbi_t468": PEAK_FLOPS / 2, "viterbi_t1404": PEAK_FLOPS / 2}
N_RAGGED_LINK = 4099  # phase 3: not a multiple of the stages' 128-burst tile
LINK_K = (128, 256, 512)  # phase 7: the dense receiver and link at larger K, B = B_LARGE_K
N_CHUNKS = 4096  # service batch: 8.4 M owned samples a step
CHUNK_LEN = 2048
N_RAGGED, RAGGED_TRIM = 37, 5  # chunks of T - 5 samples: not 128-aligned
CODED_SNR_DB = 10.0  # phase 11's services link
QAM64_SNR_DB = 25.0  # phase 11's coded 64-QAM services link (4 IC passes)
VITERBI_T = (468, 1404)  # phase 11: the coded QPSK and 64-QAM trellis lengths
SOURCES = {
    "tx": ("tx_frame_fused", "gfdm_tpu_torch/csrc/tx.cu",
           "gfdm_tpu/kernels/fused.py:1662"),
    "tx_cdd": ("tx_cdd_fused", "gfdm_tpu_torch/csrc/tx.cu",
               "gfdm_tpu/kernels/fused.py:1709"),
    "rx": ("rx_receiver_fused", "gfdm_tpu_torch/csrc/link.cu",
           "gfdm_tpu/kernels/fused.py:343"),
    "link": ("link_single_fused", "gfdm_tpu_torch/csrc/link.cu",
             "gfdm_tpu/kernels/fused.py:1403"),
    "detect_front": ("detect_front_fused", "gfdm_tpu_torch/csrc/detect.cu",
                     "gfdm_tpu/kernels/detect.py:71"),
    "detect_lean": ("detect_bursts_fused", "gfdm_tpu_torch/csrc/detect.cu",
                    "gfdm_tpu/kernels/detect.py:164"),
    "tx_factored": ("tx_frame_factored", "gfdm_tpu_torch/csrc/factored.cu",
                    "gfdm_tpu/kernels/fused.py:1847"),
    "rx_factored": ("rx_receiver_factored(estimator=fused): rx_estimate_kernel + "
                    "rx_factored_kernel", "gfdm_tpu_torch/csrc/factored.cu",
                    "gfdm_tpu/kernels/fused.py:849"),
    "rx_estimate": ("rx_receiver_factored(estimator=fused)'s estimator GEMM "
                    "(rx_estimate_kernel)", "gfdm_tpu_torch/csrc/factored.cu",
                    "gfdm_tpu/kernels/fused.py:854"),
    "rx_factored_chan": ("rx_receiver_factored(estimator=fast)",
                         "gfdm_tpu_torch/csrc/factored.cu",
                         "gfdm_tpu/kernels/fused.py:862"),
    "rx_core": ("rx_core_fused", "gfdm_tpu_torch/csrc/rx.cu",
                "gfdm_tpu/kernels/fused.py:143"),
    "rx_ic": ("rx_ic_fused", "gfdm_tpu_torch/csrc/rx.cu",
              "gfdm_tpu/kernels/fused.py:206"),
    "rx_full": ("rx_full_fused", "gfdm_tpu_torch/csrc/rx.cu",
                "gfdm_tpu/kernels/fused.py:684"),
    "rx_hybrid": ("rx_receiver_hybrid", "gfdm_tpu_torch/csrc/rx.cu",
                  "gfdm_tpu/kernels/fused.py:1074"),
    **{f"chain_{v}": (f"gemm_chain({v})", "gfdm_tpu_torch/csrc/chain.cu",
                      "benchmarks/int8_gauss.py:85") for v in ("f32", "bf16", "int8")},
    # no TPU kernel: the JAX decoder is lax.scan
    **{f"viterbi_t{T}": (f"viterbi_decode (kernels.viterbi.decode, T={T})",
                         "gfdm_tpu_torch/csrc/viterbi.cu", None) for T in VITERBI_T},
}
B_CHAIN = 65536  # phase 10: the link's batch
CHAIN_TOL = {"f32": 1e-5, "bf16": 1e-2}  # int8: bit for bit
CHAIN_LAUNCHES = {"f32": 3, "bf16": 4, "int8": 4}  # kernels of one chain call
B_OPTIONS = 16384  # phase 8's receiver checks
N_RAGGED_CDD = 4099
# phase 7: the crossover study's link points (K, B) and the full-width one;
# estimator="fused" runs at K = 128, where its dense (4K, 2N) E is 4.7 MB
LARGE_K = ((256, 4096), (512, 4096), (1024, 2048))
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


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _max_abs(a, b) -> float:
    return float((a - b).abs().max())


def _max_rel(a, b) -> float:
    return float(((a - b).abs() / (b.abs() + 1e-12)).max())


def _rel_excess(a, b, atol: float, rtol: float) -> float:
    """max(|a - b| - rtol |b|) / atol: <= 1 where a is within atol + rtol |b|."""
    return float(((a - b).abs() - rtol * b.abs()).max()) / atol


def _time_ms(torch, fn, iters: int = 5) -> float:
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def _timed(torch, fn_k, fn_p):
    """Kernel and plain times in turns (plain, kernel, kernel, plain):
    (kernel ms, plain ms, "k1/k2", "p1/p2")."""
    p1, k1, k2, p2 = (_time_ms(torch, f) for f in (fn_p, fn_k, fn_k, fn_p))
    return (k1 + k2) / 2, (p1 + p2) / 2, f"{k1:.3f}/{k2:.3f}", f"{p1:.3f}/{p2:.3f}"


def _device_busy(torch, fn, calls: int = 3):
    """(device busy ms a call of ``fn``, the part of it in the staged
    receiver's kernels): torch.profiler's device time of every kernel over
    ``calls`` calls after a warm-up; None where the profiler records no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy = rx = 0.0
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        busy += us
        if "gfdm::lg::" in ev.key:
            rx += us
    if busy == 0.0:
        return None
    return busy / 1e3 / calls, rx / 1e3 / calls


def _noisy(torch, bursts, seed: int, snr_db: float = 20.0):
    """bursts + AWGN at snr_db (noise drawn with numpy from ``seed``)."""
    sig_pow = float((bursts**2).sum(dim=1).mean())  # mean |x|^2 per sample
    sigma = (sig_pow / 10 ** (snr_db / 10) / 2) ** 0.5
    noise = np.random.default_rng(seed).standard_normal(tuple(bursts.shape),
                                                        dtype=np.float32)
    return bursts + sigma * torch.from_numpy(noise).to(bursts.device)


def _reset_launches() -> None:
    from gfdm_tpu_torch.kernels import chain, detect, fused, viterbi

    for counts in (fused.LAUNCHES, detect.LAUNCHES, chain.LAUNCHES, viterbi.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _launches() -> dict:
    from gfdm_tpu_torch.kernels import chain, detect, fused, viterbi

    return {**fused.LAUNCHES, **detect.LAUNCHES, **chain.LAUNCHES, **viterbi.LAUNCHES}


def _check_traces(got, ref, names, check) -> tuple[list, float]:
    parts, e = [], 0.0
    for name, g, r in zip(names, got, ref):
        if tuple(g.shape) != tuple(r.shape):
            parts.append(check(f"{name}_shape", 1.0, 0.0))
            continue
        e = max(e, _max_abs(g, r))
        parts.append(check(name, _rel_excess(g, r, TOL["trace_atol"], TOL["trace_rtol"]),
                           1.0))
    return parts, e


def _check_front(cfg, s, label, check, limit: int = CHUNK_LEN, tag: str = "3") -> float:
    """Kernel A through its wrapper against its plain version."""
    from gfdm_tpu_torch.kernels import detect

    n_valid = min(s.shape[-1] - 2 * cfg.subcarriers, limit)
    got = detect.detect_front_fused(cfg, s, limit)
    ref = detect._detect_front_plain(cfg, s, n_valid)
    parts, e = _check_traces(got, ref, ("gated", "ac", "energy", "ic"), check)
    print(f"[{tag} check] detect_front[{label}] max_abs={e:.3e} (traces: excess over "
          f"atol {TOL['trace_atol']} + rtol {TOL['trace_rtol']}) " + " ".join(parts),
          flush=True)
    return e


def _check_lean(torch, cfg, s, label, check, failures, limit: int = CHUNK_LEN,
                tag: str = "3") -> float:
    """Kernel B's traces and its detection dict against the plain versions."""
    from gfdm_tpu_torch.kernels import detect

    n_valid = min(s.shape[-1] - 2 * cfg.subcarriers, limit)
    got_tr = detect._detect_lean_cuda(cfg, s, n_valid)
    ref_tr = detect._detect_lean_plain(cfg, s, n_valid)
    parts, e = _check_traces(got_tr, ref_tr, ("gated", "ic"), check)
    got = detect.detect_bursts_fused(cfg, s, limit)
    ref = detect._lean_epilogue(cfg, s, *ref_tr)
    n_diff = int((got["start"] != ref["start"]).sum())
    parts.append(check("start_mismatch", float(n_diff), 0.0))
    for key in ("cfo", "scale", "strength", "ac_peak", "noise_floor"):
        parts.append(check(key, _rel_excess(got[key], ref[key], TOL["peak_atol"],
                                            TOL["peak_rtol"]), 1.0))
    if not all(bool(torch.isfinite(v).all()) for v in got.values()):
        failures.append(f"detect_lean[{label}]: non-finite outputs")
    print(f"[{tag} check] detect_lean[{label}] max_abs={e:.3e} " + " ".join(parts),
          flush=True)
    return e


def _xcorr_yardstick(torch, cfg, s, card) -> None:
    """[6 note]: conv1d (cuDNN, TF32 off) of the detection kernels'
    cross-correlation alone at the service's shape, 2K taps over every
    position: one stage of their function, so not their library_ms, and the
    port's kernels never call it."""
    from gfdm_tpu_torch.kernels import detect
    from gfdm_tpu_torch.ops.planar_pipeline import _conv_xcorr

    w = detect._consts(cfg, s.device)["conv"]
    ms = _time_ms(torch, lambda: _conv_xcorr(s, w))
    print(f"[6 note] conv1d of the 2K-tap cross-correlation alone, ({s.shape[0]}, 2, "
          f"{s.shape[-1]}) x (2, 2, {w.shape[-1]}), TF32 off: {ms:.3f} ms ({card})", flush=True)


def _service_phase(torch, cfg, dev, streams, card, check, failures):
    """Phase 6: the streaming receive service through StreamingReceiver.

    Returns the detection kernels' launch counts from their main-path runs
    and their (kernel, plain) times at the service's shapes."""
    from gfdm_tpu_torch.kernels import detect, fused
    from gfdm_tpu_torch.ops import planar_pipeline as pp
    from gfdm_tpu_torch.runtime.service import ServiceStats, StreamingReceiver

    default_impl = pp.DETECT_IMPL
    setups = (("friendly", "pallas2", 1), ("friendly", "pallas", 1),
              ("friendly", "twostage", 1), ("impaired", "pallas", 2),
              ("impaired", "twostage", 2))
    kernel_of = {"pallas2": "detect_lean", "pallas": "detect_front"}
    res, launches = {}, {}
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
        _reset_launches()
        t0 = time.perf_counter()
        out = rx.step(chunks)  # the user's entry: copy in, step, fetch
        host_s = time.perf_counter() - t0
        run = _launches()
        ms = _time_ms(torch, lambda: rx._step(dev_chunks))
        busy = _device_busy(torch, lambda: rx._step(dev_chunks))
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
            if impl in kernel_of:
                launches[kernel_of[impl]] = run[kernel_of[impl]]
        res[(stream_name, impl)] = (found, evm)
        print(f"[6 service] {stream_name} k={k} DETECT_IMPL={impl}: found="
              f"{int(out['found'].sum())}/{int(counts.sum())}={found:.6f} "
              + (f"evm_found={evm:.6f} " if stream_name == "friendly" else "")
              + f"device step {ms:.3f} ms = {samples / (ms / 1e3):.4e} samples/s "
              + ("device busy not measured " if busy is None else
                 f"device busy {busy[0]:.3f} ms (receiver {busy[1]:.3f} ms, idle "
                 f"{1 - busy[0] / ms:.1%}) ")
              + f"(host step incl. copies {host_s * 1e3:.1f} ms) launches="
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

    # detection kernels vs their plain versions at the service's shapes
    s = torch.from_numpy(streams["friendly"][0]).to(dev)
    times = {}
    for key, kern, plain in (
        ("detect_front", detect._detect_front_cuda, detect._detect_front_plain),
        ("detect_lean", detect._detect_lean_cuda, detect._detect_lean_plain),
    ):
        k_ms, p_ms, ks, ps = _timed(torch, lambda: kern(cfg, s, CHUNK_LEN),
                                    lambda: plain(cfg, s, CHUNK_LEN))
        times[key] = (k_ms, p_ms)
        print(f"[6 time] {key}: kernel {ks} ms, plain {ps} ms,"
              f" kernel {N_CHUNKS * s.shape[-1] / (times[key][0] / 1e3):.4e} samples/s "
              f"(B={N_CHUNKS}, T={s.shape[-1]}, {card})", flush=True)
    _xcorr_yardstick(torch, cfg, s, card)
    del s

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
    return launches, times


def _factored_link_plain(cfg, data, estimator: str):
    """The factored link through the kernels' plain versions: Tx, the
    channel (torch-op estimate, or the dense estimator inside the plain
    receiver), receiver, demap."""
    from gfdm_tpu_torch.kernels import fused

    bursts = fused._tx_factored_plain(cfg, data, 0)
    chan = fused._fast_channel(cfg, bursts) if estimator == "fast" else None
    _chan, sym = fused._rx_factored_plain(cfg, bursts, chan, 2)
    return sym[..., fused._factored_consts(cfg, data.device)["demap_idx"]]


def _large_k_phase(torch, dev, card, check, failures):
    """Phase 7: the factored kernels and the large-K link.

    Returns the factored kernels' launch counts from the main-path run,
    their max errors against the plain versions, the dense receiver's and
    link's errors at K = 128-512, and (kernel, plain) times at the
    full-width points."""
    from gfdm_tpu_torch.entry import large_k_config, planar_payload
    from gfdm_tpu_torch.kernels import fused
    from gfdm_tpu_torch.ops.planar_pipeline import evm, link_step_planar

    batch = {K_ESTIMATOR: B_LARGE_K, **dict(LARGE_K)}
    cfgs = {K: large_k_config(K) for K in batch}
    payload = {K: torch.from_numpy(planar_payload(cfgs[K], batch[K], seed=K)).to(dev)
               for K in batch}
    err = {"tx_factored": 0.0, "rx_factored": 0.0, "rx_factored_chan": 0.0,
           "rx": 0.0, "link": 0.0}

    # 7a. each factored kernel against its plain version on the same inputs,
    # at every K that 7c times
    for K, estimator in tuple((K, "fast") for K, _b in LARGE_K) + ((K_ESTIMATOR, "fused"),):
        cfg, data = cfgs[K], payload[K]
        key = "rx_factored_chan" if estimator == "fast" else "rx_factored"
        bursts = fused.tx_frame_factored(cfg, data)
        e_tx = _max_abs(bursts, fused._tx_factored_plain(cfg, data, 0))
        err["tx_factored"] = max(err["tx_factored"], e_tx)
        noisy = _noisy(torch, bursts, K)
        chan, sym = fused.rx_receiver_factored(cfg, noisy, estimator=estimator)
        ref_chan = fused._fast_channel(cfg, noisy) if estimator == "fast" else None
        rchan, rsym = fused._rx_factored_plain(cfg, noisy, ref_chan, 2)
        ec, es = _max_abs(chan, rchan), _max_abs(sym, rsym)
        err[key] = max(err[key], ec, es)
        print(f"[7 check] K={K} B={batch[K]} " + " ".join([
            check("tx_factored", e_tx, TOL["tx"]),
            check(f"{key}:chan", ec, TOL["chan"]),
            check(f"{key}:symbols", es, TOL["symbols"]),
        ]), flush=True)
        del bursts, noisy, chan, sym, rchan, rsym

    # 7a. the staged dense receiver and link at K = 128, 256 and 512
    # (N = 1152 .. 4608), in their 128-burst tiles
    for K in LINK_K:
        Bk = batch[K]
        noisy = _noisy(torch, fused.tx_frame_fused(cfgs[K], payload[K]), K + 1).contiguous()
        before = fused.LAUNCHES["rx"]
        chan, sym, _met = fused.rx_receiver_fused(cfgs[K], noisy)
        n_launch = fused.LAUNCHES["rx"] - before
        rchan, rsym, _rmet = fused._rx_receiver_plain(cfgs[K], noisy.reshape(Bk, -1), 2, "conv")
        ec = _max_abs(chan.reshape(Bk, -1), rchan)
        es = _max_abs(sym.reshape(Bk, -1), rsym)
        err["rx"] = max(err["rx"], ec, es)
        parts = [check("rx:chan", ec, TOL["chan"]), check("rx:symbols", es, TOL["symbols"]),
                 check("rx:launches!=plan", float(n_launch != fused.rx_launches(2)), 0.0)]
        del noisy, chan, sym, rchan, rsym
        for mode in ("conv", "matmul"):
            d_hat, _snr, evm_k = fused.link_single_fused(cfgs[K], payload[K], ic_mode=mode)
            ref, _met = fused._link_single_plain(cfgs[K], payload[K].reshape(batch[K], -1), 2,
                                                 mode)
            e = _max_abs(d_hat.reshape(batch[K], -1), ref)
            err["link"] = max(err["link"], e)
            evm_p = float(evm(ref.reshape(payload[K].shape), payload[K]))
            parts += [check(f"link[{mode}]:data", e, TOL["data"]),
                      check("|d_evm|", abs(float(evm_k) - evm_p), TOL["evm"]),
                      check("evm", float(evm_k), TOL["evm_max"])]
            del d_hat, ref
        print(f"[7 check] dense receiver and link at K={K} B={Bk} (128-burst tiles) "
              + " ".join(parts), flush=True)

    # 7b. the large-K link through the user's entry points, each path's
    # launches counted from zero (row 6, estimator="fused": the estimator
    # GEMM under "rx_factored", then the receiver under "rx_factored_chan")
    links, runs = {}, {}
    host_s = 0.0
    for K, est in ((K_FULL, "fast"), (K_ESTIMATOR, "fused")):
        _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        links[(K, est)] = fused.link_step_factored(cfgs[K], payload[K], estimator=est)
        torch.cuda.synchronize()
        host_s += time.perf_counter() - t0
        run = _launches()
        runs[est] = {key: run[key] for key in ("tx_factored", "rx_factored", "rx_factored_chan")}
    fast, fusd = runs["fast"], runs["fused"]
    row6 = {"rx_estimate_kernel": fusd["rx_factored"], "rx_factored_kernel": fusd["rx_factored_chan"]}
    # row 7 (rx_factored_chan) is the fast link's receiver; row 6's receiver
    # launch stands in the rx_factored entry's launches_by_kernel
    launches = {"tx_factored": fast["tx_factored"] + fusd["tx_factored"],
                "rx_factored": sum(row6.values()), "rx_estimate": fusd["rx_factored"],
                "rx_factored_chan": fast["rx_factored_chan"]}
    for key, v in launches.items():
        if v < 1:
            failures.append(f"kernel {key} was not launched on the large-K path")
    if tuple(row6.values()) != (1, 1) or fast["rx_factored"] != 0:
        failures.append(f"row 6: launches {row6} on the estimator=fused link (expected one "
                        f"each), rx_factored {fast['rx_factored']} on the fast one")
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

    # 7c. times: kernel vs plain (plain, kernel, kernel, plain) and the link
    # through the kernels, their plain versions and the torch-op fast chain
    times = {}

    for K, Bk in LARGE_K + ((K_ESTIMATOR, B_LARGE_K),):
        cfg, data = cfgs[K], payload[K]
        bursts = fused.tx_frame_factored(cfg, data)
        if K == K_ESTIMATOR:
            runs = {"rx_factored": (
                lambda: fused.rx_receiver_factored(cfg, bursts, estimator="fused"),
                lambda: fused._rx_factored_plain(cfg, bursts, None, 2))}
        else:
            chan = fused._fast_channel(cfg, bursts)
            runs = {
                "tx_factored": (lambda: fused.tx_frame_factored(cfg, data),
                                lambda: fused._tx_factored_plain(cfg, data, 0)),
                "rx_factored_chan": (lambda: fused._rx_factored_cuda(cfg, bursts, chan, 2),
                                     lambda: fused._rx_factored_plain(cfg, bursts, chan, 2)),
                "link": (lambda: fused.link_step_factored(cfg, data),
                         lambda: _factored_link_plain(cfg, data, "fast")),
            }
        for name, (fn_k, fn_p) in runs.items():
            k_ms, p_ms, ks, ps = _timed(torch, fn_k, fn_p)
            if K in (K_FULL, K_ESTIMATOR) and name != "link":
                times[name] = (k_ms, p_ms)
            bounds = ""
            if name != "link":  # the restated bound, the direct DFT's beside it
                b_ms, b_by = _bound(name, cfg, Bk)
                d_ms = _bound(name, cfg, Bk, direct_dft=True)[0]
                bounds = (f"; bound {b_ms:.3f} ms ({b_by}) = {b_ms / k_ms:.1%}, direct-DFT "
                          f"bound {d_ms:.3f} ms = {d_ms / k_ms:.1%}")
            print(f"[7 time] K={K} B={Bk} {name}: kernel {ks} ms, plain {ps} ms{bounds} "
                  f"({card})", flush=True)
            if name == "link":
                chain = _time_ms(torch, lambda: link_step_planar(cfg, data, method="fast"))
                est = _time_ms(torch, lambda: fused._fast_channel(cfg, bursts))
                sps = Bk * cfg.frame_len
                print(f"[7 time] K={K} B={Bk} link samples/s: kernels "
                      f"{sps / (k_ms / 1e3):.4e}, plain {sps / (p_ms / 1e3):.4e}, "
                      f"torch-op fast chain {sps / (chain / 1e3):.4e} ({chain:.3f} ms); "
                      f"torch-op estimate {est:.3f} ms ({card})", flush=True)
        if K == K_ESTIMATOR:
            times["rx_estimate"] = _estimate_gemm_line(torch, cfg, bursts, err, check, card)
        if K != K_ESTIMATOR:
            _kstage_yardstick(torch, cfg, bursts, card)
        if K in (K_FULL, 1024):
            _factored_link_stages(torch, cfg, data, card)
        del bursts
    return launches, err, times, row6


def _estimate_gemm_line(torch, cfg, bursts, err, check, card) -> tuple:
    """[7 time] row 6's estimator GEMM alone: kernel and plain ms, torch.mm
    of the same product (TF32 off; the yardstick, which the port never
    calls), the bound and the largest error against a float64 product.
    Returns (kernel, plain, torch.mm) ms; sets err["rx_estimate"] (vs plain)."""
    from gfdm_tpu_torch.kernels import fused

    B, K = bursts.shape[0], cfg.subcarriers
    got = fused._rx_estimate_cuda(cfg, bursts)
    err["rx_estimate"] = _max_abs(got, fused._rx_estimate_plain(cfg, bursts))
    e_w = fused._estimator_op(cfg, bursts.device)
    pre2 = bursts[..., cfg.cp_len : cfg.cp_len + 2 * K].reshape(B, 4 * K).contiguous()
    ref = (pre2.double() @ e_w.double()).reshape(got.shape)
    rel64 = _max_abs(got.double(), ref) / float(ref.abs().max())
    del got, ref
    k_ms, p_ms, ks, ps = _timed(torch, lambda: fused._rx_estimate_cuda(cfg, bursts),
                                lambda: fused._rx_estimate_plain(cfg, bursts))
    lib_ms = _time_ms(torch, lambda: torch.mm(pre2, e_w))
    b_ms, b_by = _bound("rx_estimate", cfg, B)
    print(f"[7 time] K={K} B={B} rx_estimate (row 6's estimator GEMM alone): kernel {ks} ms, "
          f"plain {ps} ms, torch.mm(pre2, E_W) TF32 off {lib_ms:.3f} ms; bound {b_ms:.3f} ms "
          f"({b_by}) = {b_ms / k_ms:.1%}; vs plain max |d| {err['rx_estimate']:.3e}, "
          + check("vs float64 max |d| / max |H|", rel64, TOL["estimate64"]) + f" ({card})",
          flush=True)
    return k_ms, p_ms, lib_ms


def _kstage_yardstick(torch, cfg, bursts, card) -> None:
    """[7 note]: torch.fft.fft (cuFFT) of the factored kernels' K-point stage
    alone, on the bursts' payload rows as (B, M, K) complex64 (row n1 holds
    samples M n2 + n1); not the kernels' whole function, so not their
    library_ms, and the port never calls it."""
    B, K, M, n = bursts.shape[0], cfg.subcarriers, cfg.timeslots, cfg.block_len
    fs = cfg.preamble_len + cfg.cp_len
    x = bursts[..., fs : fs + n]
    rows = torch.complex(x[:, 0], x[:, 1]).reshape(B, K, M).transpose(1, 2).contiguous()
    ms = _time_ms(torch, lambda: torch.fft.fft(rows, dim=-1))
    print(f"[7 note] K={K} B={B}: torch.fft.fft (cuFFT) of the K-point stage alone, "
          f"({B}, {M}, {K}) complex64 rows: {ms:.3f} ms ({card})", flush=True)


def _factored_link_stages(torch, cfg, data, card, reps: int = 3) -> None:
    """[7 stages]: link_step_factored's device time a stage (CUDA events
    around each, as the link runs them): the Tx kernel, the torch-op
    channel estimate, the receiver kernel, demap and EVM; the mean of
    ``reps`` calls after a warm-up."""
    from gfdm_tpu_torch.kernels import fused
    from gfdm_tpu_torch.ops.planar_pipeline import evm

    demap = fused._factored_consts(cfg, data.device)["demap_idx"]
    stages = (
        ("tx", lambda s: fused.tx_frame_factored(cfg, data)),
        ("estimate", lambda s: (s, fused._fast_channel(cfg, s))),
        ("rx", lambda s: fused._rx_factored_cuda(cfg, s[0], s[1], 2)[1]),
        ("demap+evm", lambda s: evm(s[..., demap], data)),
    )

    def run(events):
        state = None
        for _name, fn in stages:
            if events is not None:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            state = fn(state)
        if events is not None:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()

    names, ms = _stage_ms(run, [(name, None, 0) for name, _fn in stages], reps)
    print(f"[7 stages] link_step_factored K={cfg.subcarriers} B={data.shape[0]}: "
          + " ".join(f"{n} {t:.3f}" for n, t in zip(names, ms))
          + f" = {sum(ms):.3f} ms ({card})", flush=True)


def _stage_ms(run, plan, reps: int = 3) -> tuple[list, list]:
    """(stage names, device ms of each launch) of ``run(events)``, which
    records a CUDA event before each launch of ``plan`` and after the last:
    the mean of ``reps`` calls after a warm-up."""
    run(None)
    ms = [0.0] * len(plan)
    for _ in range(reps):
        ev = []
        run(ev)
        ev[-1].synchronize()
        for i in range(len(plan)):
            ms[i] += ev[i].elapsed_time(ev[i + 1]) / reps
    return [name if name != "ic" else f"ic{it}" for name, _s, it in plan], ms


def _tx_yardstick(torch, cfg, flat, tx_ms: float, card) -> None:
    """[5 note]: the Tx core's three products alone, as the plain version
    runs them (three torch.mm, TF32 off: cuBLAS's SGEMM), without the
    framing; not the Tx's whole function, so not its library_ms."""
    from gfdm_tpu_torch.kernels import fused

    nd = cfg.n_data_symbols
    tg = fused._kernel_consts(cfg, flat.device)["T_G"]
    xr, xi = flat[:, :nd].contiguous(), flat[:, nd:].contiguous()
    s = xr + xi
    w1, w2, w3 = tg[:nd], tg[nd : 2 * nd], tg[2 * nd :]
    mm_ms = _time_ms(torch, lambda: (torch.mm(xr, w1), torch.mm(xi, w2), torch.mm(s, w3)))
    print(f"[5 note] tx core as three torch.mm ({flat.shape[0]}, {nd}) @ ({nd}, "
          f"{cfg.block_len}), TF32 off: {mm_ms:.3f} ms; the tx kernel {tx_ms:.3f} ms = "
          f"{mm_ms / tx_ms:.1%} of their rate with the framing ({card})", flush=True)


def _link_stage_times(torch, cfg, flat, card) -> None:
    """Phase 5: the link's device time a stage (CUDA events around each
    launch) at the main path's batch, both IC modes and both stack dtypes,
    and what an IC iteration costs."""
    from gfdm_tpu_torch.kernels import fused

    ic = {}
    for dtype_name in ("float32", "bfloat16"):
        for mode in ("matmul", "conv"):
            opts = fused._rx_options(2, mode)
            names, ms = _stage_ms(
                lambda ev: fused._link_single_cuda(cfg, flat, opts, dtype_name, events=ev),
                fused._link_plan(opts.ic_iterations))
            ic[(mode, dtype_name)] = sum(ms[len(fused.LINK_STAGES):]) / opts.ic_iterations
            print(f"[5 stages] link[{mode},{dtype_name}] B={flat.shape[0]}: "
                  + " ".join(f"{n} {t:.3f}" for n, t in zip(names, ms))
                  + f" = {sum(ms):.3f} ms ({card})", flush=True)
    for dtype_name in ("float32", "bfloat16"):
        print(f"[5 stages] one IC iteration ({dtype_name} stacks): matmul "
              f"{ic[('matmul', dtype_name)]:.3f} ms (bf16 operator on tensor cores), conv "
              f"{ic[('conv', dtype_name)]:.3f} ms (M-tap stencil); entry() runs matmul "
              f"({card})", flush=True)


def _rx_stage_times(cfg, flat, card, phase: str) -> None:
    """The receiver's device time a stage (CUDA events around each launch)
    on the burst rows ``flat``, both IC modes and, with the conv IC, the
    phase stage."""
    from gfdm_tpu_torch.kernels import fused

    for mode, comp in (("conv", False), ("matmul", False), ("conv", True)):
        opts = fused._rx_options(2, mode, phase_compensation=comp)
        names, ms = _stage_ms(lambda ev: fused._rx_receiver_cuda(cfg, flat, opts, events=ev),
                              fused._rx_plan(opts.ic_iterations, comp))
        label = mode + (",phase" if comp else "")
        print(f"[{phase} stages] rx[{label}] B={flat.shape[0]}: "
              + " ".join(f"{n} {t:.3f}" for n, t in zip(names, ms))
              + f" = {sum(ms):.3f} ms ({card})", flush=True)


def _rx_bound(cfg, batch: int, ic_mode: str = "conv",
              fp64: bool = False) -> tuple[float, str, float]:
    """The staged receiver's bound, stated as the link's: its four
    float32-stack Gauss products (estimate, preamble DFT, block DFT, demod)
    as three TF32 products each at 495 TFLOP/s (the card's fastest
    float32-accurate products; ``fp64``: at the FP64 tensor cores' 67
    TFLOP/s, where the kernel sums them), the bf16 IC operator at 989
    TFLOP/s or the conv IC's taps at the fp32 FMA rate, against its bytes
    (bursts in, channel, symbols and metrics out, constants once). Returns
    (bound ms, what bounds it, ms of the design's intermediates: Y, D0, the
    decisions and the preamble power, each written once and read by each
    stage that takes it)."""
    from gfdm_tpu_torch.kernels import fused

    n, half, M, fl = cfg.block_len, 2 * cfg.subcarriers, cfg.timeslots, cfg.frame_len
    met_w, it = fused._met_layout(cfg)[1], 2
    stacks = 6.0 * batch * (half * n + half * half + 2 * n * n)
    t_ops = stacks / PEAK_FP64_TC if fp64 else 3 * stacks / PEAK_TF32
    if ic_mode == "matmul":
        t_ops += it * 6.0 * batch * n * n / PEAK_BF16
        ic_bytes = 2 * 3 * n * n
    else:
        t_ops += it * 8.0 * batch * M * n / PEAK_FLOPS
        ic_bytes = 4 * 2 * M
    wbytes = 4 * 3 * (half * n + half * half + 2 * n * n)
    t_bytes = (4.0 * batch * (2 * fl + 4 * n + met_w) + wbytes + ic_bytes) / PEAK_BYTES
    inter = 4.0 * batch * (2 * 2 * n + (1 + it) * 2 * n + 2 * it * 2 * n + 2 * half)
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            1e3 * inter / PEAK_BYTES)


def _link_bound(cfg, batch: int, ic_mode: str = "matmul",
                dtype_name: str = "float32") -> tuple[float, str, float]:
    """The staged link's bound: its operations at the tensor-core rate of
    their type - each float32-stack Gauss product as three TF32 products at
    495 TFLOP/s, the bf16 IC operator and the bf16 stacks at 989 TFLOP/s but
    those of the Tx and estimate stages, which sum in float64, at the FP64
    tensor cores' 67 TFLOP/s, the conv IC's taps at the fp32 FMA rate -
    against its bytes (payload, outputs
    and constants once). Returns (bound ms, what bounds it, ms of the
    design's intermediates: F, Y, D0, the decisions, each burst's preamble
    window and its power, each written once and read by each stage that
    takes it)."""
    from gfdm_tpu_torch.kernels import fused

    n, nd, half, M = cfg.block_len, cfg.n_data_symbols, 2 * cfg.subcarriers, cfg.timeslots
    met_w, it = fused._met_layout(cfg)[1], 2
    rounded = 6.0 * batch * (nd * n + half * n + n * n)  # Tx, estimate + DFT
    stacks = rounded + 6.0 * batch * (half * half + n * n)  # + preamble DFT, demod
    bf16 = dtype_name == "bfloat16"
    t_ops = (rounded / PEAK_FP64_TC + (stacks - rounded) / PEAK_BF16 if bf16
             else 3 * stacks / PEAK_TF32)
    if ic_mode == "matmul":
        t_ops += it * 6.0 * batch * n * n / PEAK_BF16
        ic_bytes = 2 * 3 * n * n
    else:
        t_ops += it * 8.0 * batch * M * n / PEAK_FLOPS
        ic_bytes = 4 * 2 * M
    wbytes = (2 if bf16 else 4) * 3 * (nd * n + half * n + half * half + 2 * n * n)
    t_bytes = (4.0 * batch * (4 * nd + met_w) + wbytes + ic_bytes) / PEAK_BYTES
    inter = 4.0 * batch * (2 * 2 * n * 2 + 2 * n * (1 + it) + 2 * n * 2 * it + 2 * half
                           + 3 * 2 * half)
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            1e3 * inter / PEAK_BYTES)


def _ols_flops(taps: int) -> float:
    """Operations an output of a ``taps``-tap complex cross-correlation as
    overlap-save FFTs: a forward and an inverse N-point FFT (5 N log2 N
    each) and N complex products (6 N) per N - taps + 1 outputs, at the
    best power-of-two N."""
    return min((10.0 * n * math.log2(n) + 6.0 * n) / (n - taps + 1)
               for n in (2 ** k for k in range(1, 24)) if n > taps)


def _work(key: str, cfg, batch: int, ic_mode: str = "conv", ports: int = 1,
          T: int = 0, n_valid: int = 0, direct_dft: bool = False,
          detect_form: str = "least") -> tuple[float, float]:
    """(fp32 operations, bytes) of one call of kernel ``key`` at these
    shapes: the kernel's sums as written (a real MAC is 2 operations, a
    complex MAC 8; a Gauss product of an (a, b) operator 3 a b real MACs),
    each input read once (constants included) and each output written once.
    The factored kernels' K-point stage counts as an FFT's 5 M K log2 K for K
    a power of two (what the kernels run), else, or with ``direct_dft``, as
    the direct DFT's 8 M K^2 (the count the kernels' bound used before they
    ran the FFT). The detection kernels' ``detect_form``: "least" counts the
    2K-tap cross-correlation at each gated position in its cheaper form,
    overlap-save FFTs (which the kernels do not run) or the direct FIR, and
    the other traces as window sums; "fir" the direct FIR (what the kernels
    run); "old" every sum taken anew at every position, as a kernel of one
    position a thread would."""
    from gfdm_tpu_torch.kernels import chain, fused

    if key.startswith("viterbi_"):  # radix 16 (k = 4), T trellis steps a codeword
        # a collapsed step: 2^(2k+1) - 2 pattern-sum adds, 64 x 2^k candidate
        # adds and 64 x (2^k - 1) compares; the LLRs in, the bits out, once
        k = 4
        return (batch * (T // k) * ((1 << (2 * k + 1)) - 2 + 64 * ((2 << k) - 1)),
                batch * (8.0 * T + T))
    if key.startswith("chain_"):  # x in, out, the weights once (4, 2 or 1 B)
        wbytes = {"chain_f32": 4, "chain_bf16": 2, "chain_int8": 1}[key]
        shapes = chain.CHAIN_SHAPES
        return (2.0 * batch * sum(a * b for a, b in shapes),
                4.0 * batch * (shapes[0][0] + shapes[-1][1])
                + wbytes * sum(a * b for a, b in shapes))

    n, nd, K, M, L = (cfg.block_len, cfg.n_data_symbols, cfg.subcarriers,
                      cfg.timeslots, cfg.overlap)
    half, fl, f4 = 2 * K, cfg.frame_len, 4
    met_w = fused._met_layout(cfg)[1]

    def g(a, b):  # operations and bytes of a float32 Gauss product
        return 6.0 * a * b, 12.0 * a * b

    conv_ic = 2 * 8.0 * M * n  # 2 iterations, M complex taps an output
    ic = (2 * g(n, n)[0], 6.0 * n * n) if ic_mode == "matmul" else (conv_ic, 8.0 * M)
    est, dft2, dft, bfd, tx = g(half, n), g(half, half), g(n, n), g(n, n), g(nd, n)
    rx_ops = est[0] + dft2[0] + dft[0] + bfd[0] + ic[0]
    rx_const = est[1] + dft2[1] + dft[1] + bfd[1] + ic[1]
    if key in ("tx", "tx_cdd"):
        return batch * tx[0], f4 * batch * (2 * nd + ports * 2 * fl) + tx[1]
    if key == "rx":
        return batch * rx_ops, f4 * batch * (2 * fl + 4 * n + met_w) + rx_const
    if key == "link":
        return batch * (tx[0] + rx_ops), f4 * batch * (4 * nd + met_w) + tx[1] + rx_const
    if key in ("rx_core", "rx_ic"):
        ops = dft[0] + bfd[0] + (conv_ic if key == "rx_ic" else 0.0)
        return batch * ops, f4 * batch * 6 * n + dft[1] + bfd[1]
    if key == "rx_full":
        ops = est[0] + dft[0] + bfd[0] + conv_ic
        return batch * ops, f4 * batch * (2 * fl + 2 * n) + est[1] + dft[1] + bfd[1]
    if key == "rx_hybrid":
        ops = est[0] + dft[0] + 8.0 * n * (L + M) + conv_ic
        return batch * ops, f4 * batch * (2 * fl + 4 * n) + est[1] + dft[1]
    if key == "rx_estimate":  # (B, 4K) @ (4K, 2N): bursts' windows, E_W, chan
        return 2.0 * batch * 4 * K * 2 * n, f4 * (batch * (4 * K + 2 * n) + 4 * K * 2 * n)
    fft = (K & (K - 1)) == 0 and not direct_dft
    kstage = 5.0 * M * K * math.log2(K) if fft else 8.0 * M * K * K
    if key in ("rx_factored", "rx_factored_chan"):
        ops = kstage + 8.0 * n * (2 * M + L) + conv_ic
        io = 2 * fl + 4 * n  # bursts in; chan in or out; symbols out
        if key == "rx_factored":
            return batch * (ops + 16.0 * K * n), f4 * batch * io + 32.0 * K * n
        return batch * ops, f4 * batch * io
    if key == "tx_factored":
        return batch * (kstage + 8.0 * n * (2 * M + L)), f4 * batch * (2 * nd + 2 * fl)
    if key in ("detect_front", "detect_lean"):
        # cc at each gated position: 2K complex MACs (16K operations) or
        # overlap-save FFTs, whichever is less; at every position p, e and ic as window sums, a
        # term in and a term out each (conj(a) b 6, |s|^2 3, in and out 6,
        # 2 / e and ac 3, |ac| 4, ic 3), |cc| / 2K and the gating 6: 31
        n_ac = T - 2 * K
        pos = n_ac if key == "detect_front" else n_valid
        out = 4 * n_ac + n_valid if key == "detect_front" else 2 * n_valid
        nbytes = f4 * batch * (2 * T + out)
        if detect_form == "old":
            return batch * pos * 32.0 * K, nbytes
        xc = 16.0 * K if detect_form == "fir" else min(16.0 * K, _ols_flops(2 * K))
        return batch * (n_valid * xc + pos * 31.0), nbytes
    raise KeyError(key)


def _bound(key: str, cfg, batch: int, **kw) -> tuple[float, str]:
    """The least time (ms) the card could take, and what bounds it."""
    ops, nbytes = _work(key, cfg, batch, **kw)
    t_ops, t_bytes = ops / PEAK_OPS.get(key, PEAK_FLOPS), nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _points_payload(torch, cfg, name: str, batch: int, seed: int, dev):
    """(batch, 2, n_data) planar payload of the constellation's points."""
    from gfdm_tpu_torch.ops.rx import constellation_points

    pts = constellation_points(name)
    idx = np.random.default_rng(seed).integers(0, pts.size, (batch, cfg.n_data_symbols))
    sym = np.stack([pts[idx].real, pts[idx].imag], axis=1).astype(np.float32)
    return torch.from_numpy(sym).to(dev)


def _rotate_data(torch, bursts, start: int, phi: float):
    """The burst's samples from ``start`` on rotated by ``phi`` (a common
    phase offset of the data section; the preamble estimate absorbs a
    rotation of the whole burst)."""
    c, s = np.cos(phi), np.sin(phi)
    out = bursts.clone()
    re, im = bursts[:, 0, start:], bursts[:, 1, start:]
    out[:, 0, start:] = c * re - s * im
    out[:, 1, start:] = s * re + c * im
    return out


def _levels(torch, x, name: str):
    """Per-axis decision levels of planar symbols (torch or numpy): the
    nearest point of the square Gray constellation ``name``."""
    from gfdm_tpu_torch.kernels import fused

    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    return fused._ic_level(t, name)


def _boundary_distance(u, name: str):
    """Distance of each decision input to its nearest level boundary, in
    level units (QPSK: |u|; qam: of (u scale - 1) / 2 to a half-integer)."""
    from gfdm_tpu_torch.kernels import fused

    if name == "qpsk":
        return u.abs()
    scale, _lim = fused._QAM_LEVELS[name]
    t = (u * scale - 1.0) / 2.0
    return (t - t.floor() - 0.5).abs()


def _flipped_bursts(runs, name: str, near_tol: float, mask=None, phase: bool = False):
    """Bursts whose IC decisions differ between kernel and plain version.

    ``runs``: (kernel rows, plain rows) after 0 and after 1 of the 2 IC
    iterations, (B, 2 n) each; ``mask`` (2 n) zeroes the inactive symbols.
    The output is d0 minus the interference of the last iteration's
    decisions (made on the rows after 1 iteration), so a burst is flipped
    where those differ, or, with phase compensation (whose rotation the
    first decisions set), where the first ones do. Returns the flipped mask
    and whether each flipped burst is explained by decisions within
    ``near_tol`` of a level boundary, at the last iteration or at the first
    (whose flip moves the inputs of the last)."""
    from gfdm_tpu_torch.kernels import fused

    diff, expl = [], []
    for s_k, s_p in runs:
        d = fused._ic_level(s_k, name) != fused._ic_level(s_p, name)
        if mask is not None:
            d &= mask != 0
        diff.append(d.any(dim=1))
        expl.append((~d | (_boundary_distance(s_k, name) < near_tol)).all(dim=1))
    flipped = diff[1] | diff[0] if phase else diff[1]
    explained = (diff[1] & expl[1]) | (diff[0] & expl[0]) | ~flipped
    return flipped, bool(explained.all())


def _options_phase(torch, cfg, dev, card, check, failures):
    """Phase 8: every receiver and link option through the kernels, and the
    fused-engine service at qam16 / qam64. Returns the rx and link errors
    and the rx launches of the service run."""
    from gfdm_tpu_torch.entry import service_stream
    from gfdm_tpu_torch.kernels import fused
    from gfdm_tpu_torch.runtime.service import StreamingReceiver

    Bo = B_OPTIONS
    act = fused._kernel_consts(cfg, dev)["act"]
    act2 = torch.cat([act, act])
    err = {"rx": 0.0, "link": 0.0}
    staged = {}
    cases = (("mmse", "qpsk", False, "conv"), ("mmse_cnr", "qpsk", False, "conv"),
             ("mmse_cnr", "qam16", False, "conv"), ("mmse", "qam64", False, "conv"),
             ("zf", "qpsk", True, "conv"), ("zf", "qam16", False, "matmul"))
    for ci, (eq, name, phase, mode) in enumerate(cases):
        data = _points_payload(torch, cfg, name, Bo, 80 + ci, dev)
        bursts = fused.tx_frame_fused(cfg, data)
        if phase:
            bursts = _rotate_data(torch, bursts, cfg.preamble_len, 0.1)
        noisy = _noisy(torch, bursts, 90 + ci).contiguous()
        flat = noisy.reshape(Bo, -1)
        kw = dict(constellation=name, equalizer=eq, phase_compensation=phase)
        before = fused.LAUNCHES["rx"]
        chan, sym, met = fused.rx_receiver_fused(cfg, noisy, ic_mode=mode, **kw)
        n_launch = fused.LAUNCHES["rx"] - before
        # the plain version summed in float64, as the kernels sum their
        # float32-stack products
        rchan, rsym, rmet = fused._rx_receiver_plain(cfg, flat, 2, mode, gdot=fused._gdot64,
                                                     **kw)
        # bursts whose decisions of iteration 0 or 1 differ
        runs = [(fused.rx_receiver_fused(cfg, noisy, ic_iterations=it, ic_mode=mode,
                                         **kw)[1].reshape(Bo, -1),
                 fused._rx_receiver_plain(cfg, flat, it, mode, gdot=fused._gdot64, **kw)[1])
                for it in (0, 1)]
        differ, explained = _flipped_bursts(runs, name, TOL["boundary"], act2, phase)
        # beside it, the same count against the float32 plain version, which
        # sums at float32 level in cuBLAS's order (no limit: ~1e-3 of noisy
        # qam64 bursts, tests/test_torch_rx_tc.py)
        runs32 = [(k, fused._rx_receiver_plain(cfg, flat, it, mode, **kw)[1])
                  for it, (k, _p) in enumerate(runs)]
        differ32, explained32 = _flipped_bursts(runs32, name, TOL["boundary"], act2, phase)
        del runs, runs32
        keep = ~differ
        n_ex, n_ex32 = int(differ.sum()), int(differ32.sum())
        if not (explained and explained32):
            failures.append(f"rx[{eq},{name}]: a decision differs away from a boundary")
        ec = _max_abs(chan.reshape(Bo, -1), rchan)
        es = _max_abs(sym.reshape(Bo, -1)[keep], rsym[keep])
        err["rx"] = max(err["rx"], ec, es)
        label = f"{eq},{name}" + (",phase 0.1 rad" if phase else "") + f",{mode}"
        print(f"[8 check] rx[{label}] B={Bo} vs plain(sum64) excluded={n_ex} " + " ".join([
            check("excluded_share", n_ex / Bo, TOL["excluded_share"]),
            check("chan", ec, TOL["chan"]),
            check("symbols", es, TOL["symbols"]),
            check("snr_rel", _max_rel(met[:, 0], rmet[:, 0]), TOL["snr_rtol"]),
            check("launches-plan", abs(n_launch - fused.rx_launches(2, phase)), 0.0),
        ]) + f" launches={n_launch}; vs plain(f32) excluded={n_ex32} "
            f"share={n_ex32 / Bo:.3e} at_boundary={explained32}", flush=True)
        if eq not in staged:  # the product stages on the kernel's own inputs
            staged[eq] = max(float(v.max()) for v in fused._rx_stage_errors(cfg, flat, eq)
                             .values())
            print(f"[8 check] rx stages[{eq}] on their own inputs "
                  + check("stages", staged[eq], TOL["stages"]), flush=True)
        if phase:  # the correction must matter: off, the symbols stay rotated
            idx = fused._kernel_consts(cfg, dev)["demap_idx"]
            e = {}
            for on in (True, False):
                d = fused.rx_receiver_fused(cfg, bursts, ic_mode=mode, constellation=name,
                                            equalizer=eq, phase_compensation=on)[1]
                e[on] = float((d[..., idx] - data).abs().max())
            print(f"[8 check] phase compensation on the clean rotated bursts: max "
                  f"|d - payload| on {e[True]:.4f} off {e[False]:.4f} "
                  + check("on/off", e[True] / e[False], 0.5), flush=True)
        del noisy, flat, chan, sym, rchan, rsym
    for name, dtype_name in (("qam16", "float32"), ("qam64", "float32"),
                             ("qpsk", "bfloat16"), ("qam16", "bfloat16")):
        data = _points_payload(torch, cfg, name, Bo, 70, dev)
        flat = data.reshape(Bo, -1)
        lkw = dict(constellation=name, dtype_name=dtype_name)
        bf16 = dtype_name == "bfloat16"
        pkw = dict(dtype_name=dtype_name, sum64=bf16)
        d_hat, _snr, evm_k = fused.link_single_fused(cfg, data, ic_mode="matmul", **lkw)
        ref, _met = fused._link_single_plain(cfg, flat, 2, "matmul", name, **pkw)
        runs = [(fused.link_single_fused(cfg, data, ic_iterations=it, ic_mode="matmul",
                                         **lkw)[0].reshape(Bo, -1),
                 fused._link_single_plain(cfg, flat, it, "matmul", name, **pkw)[0])
                for it in (0, 1)]
        differ, explained = _flipped_bursts(
            runs, name, TOL["bf16_boundary"] if bf16 else TOL["boundary"])
        del runs
        if not explained:
            failures.append(f"link[{name},{dtype_name}]: a decision differs away from a "
                            "boundary")
        extra = []
        if bf16:  # the product stages on the kernel's own inputs
            stage = max(float(v.max()) for v in
                        fused._link_stage_errors(cfg, flat, dtype_name).values())
            extra = [check("stages", stage, TOL["stages"])]
        keep = ~differ
        n_ex = int(differ.sum())
        e = _max_abs(d_hat.reshape(Bo, -1)[keep], ref[keep])
        err["link"] = max(err["link"], e)
        evm_p = float(((ref - flat) ** 2).sum() / (flat**2).sum()) ** 0.5
        tol = TOL["data"] if dtype_name == "float32" else TOL["bf16_data"]
        # the clean loopback's own decision errors (qam64 has a floor): the
        # kernel's must be the plain version's
        wrong = int((_levels(torch, d_hat, name) != _levels(torch, data, name)).sum())
        wrong_p = int((_levels(torch, ref.reshape(data.shape), name)
                       != _levels(torch, data, name)).sum())
        over = int(((d_hat.reshape(Bo, -1) - ref).abs().amax(dim=1) > TOL["data"]).sum())
        print(f"[8 check] link[{name},{dtype_name},matmul] B={Bo} evm={float(evm_k):.6f} "
              f"plain{'(sum64)' if bf16 else ''}={evm_p:.6f} excluded={n_ex} bursts over {TOL['data']}: {over} "
              f"wrong decisions {wrong} plain {wrong_p} "
              + " ".join([check("excluded_share", n_ex / Bo,
                                TOL["bf16_excluded_share" if bf16 else "excluded_share"]),
                          check("data", e, tol),
                          check("|d_evm|", abs(float(evm_k) - evm_p), TOL["evm"]),
                          check("|d_wrong|", float(abs(wrong - wrong_p)),
                                0.01 * wrong_p + 2), *extra]), flush=True)
        del data, flat, d_hat, ref

    # option costs at B_OPTIONS (plain, kernel, kernel, plain): the receiver
    # at mmse_cnr / qam16 beside zf / qpsk, the link with bf16 stacks beside
    # float32
    data = _points_payload(torch, cfg, "qam16", Bo, 60, dev)
    noisy = _noisy(torch, fused.tx_frame_fused(cfg, data), 61).contiguous()
    flat, nflat = data.reshape(Bo, -1), noisy.reshape(Bo, -1)
    runs = {
        "rx[zf,qpsk]": (lambda: fused.rx_receiver_fused(cfg, noisy),
                        lambda: fused._rx_receiver_plain(cfg, nflat, 2, "conv")),
        "rx[mmse_cnr,qam16]": (
            lambda: fused.rx_receiver_fused(cfg, noisy, equalizer="mmse_cnr",
                                            constellation="qam16"),
            lambda: fused._rx_receiver_plain(cfg, nflat, 2, "conv", equalizer="mmse_cnr",
                                             constellation="qam16")),
        "link[float32,matmul]": (
            lambda: fused.link_single_fused(cfg, data, ic_mode="matmul"),
            lambda: fused._link_single_plain(cfg, flat, 2, "matmul")),
        "link[bfloat16,matmul]": (
            lambda: fused.link_single_fused(cfg, data, ic_mode="matmul", dtype_name="bfloat16"),
            lambda: fused._link_single_plain(cfg, flat, 2, "matmul", dtype_name="bfloat16")),
    }
    for label, (fn_k, fn_p) in runs.items():
        _k, _p, ks, ps = _timed(torch, fn_k, fn_p)
        print(f"[8 time] {label}: kernel {ks} ms, plain {ps} ms (B={Bo}, {card})", flush=True)
    del data, noisy, flat, nflat, runs

    # the service at qam16 / qam64: fused engine vs the torch-op xla engine
    rx_launches, samples = 0, N_CHUNKS * CHUNK_LEN
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
        _reset_launches()
        out = fused_rx.step(chunks)
        run = _launches()
        rx_launches = run["rx"]
        if run["rx"] < 1:
            failures.append(f"kernel rx was not launched on the service path ({name})")
        ref = xla_rx.step(chunks)
        ms = _time_ms(torch, lambda: fused_rx._step(dev_chunks))
        ms_x = _time_ms(torch, lambda: xla_rx._step(dev_chunks))
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
    return err, rx_launches


def _cdd_variants_phase(torch, cfg, dev, data, noisy, card, check, failures):
    """Phase 9: the CDD transmitter and two-antenna link, and the four
    superseded receivers. Returns launches, errors and (kernel, plain) ms."""
    from gfdm_tpu_torch import GfdmConfig
    from gfdm_tpu_torch.entry import cdd_channel, cdd_link
    from gfdm_tpu_torch.kernels import fused

    Bc = data.shape[0]
    flat = data.reshape(Bc, -1)
    cfg_c = GfdmConfig(cyclic_shifts=(0, 2))
    err, launches, times = {}, {}, {}
    got = fused.tx_cdd_fused(cfg_c, data)
    e1 = _max_abs(got.reshape(Bc, -1), fused._tx_cdd_plain(cfg_c, flat).reshape(Bc, -1))
    cfg_r = GfdmConfig(cyclic_shifts=(0, 3, 7))
    small = data[:N_RAGGED_CDD].contiguous()
    got_r = fused.tx_cdd_fused(cfg_r, small)
    e2 = _max_abs(got_r.reshape(N_RAGGED_CDD, -1),
                  fused._tx_cdd_plain(cfg_r, small.reshape(N_RAGGED_CDD, -1))
                  .reshape(N_RAGGED_CDD, -1))
    err["tx_cdd"] = max(e1, e2)
    print(f"[9 check] " + " ".join([check(f"tx_cdd[B={Bc},shifts=(0,2)]", e1, TOL["tx"]),
                                    check(f"tx_cdd[B={N_RAGGED_CDD},shifts=(0,3,7)]", e2,
                                          TOL["tx"])])
          + f" bit_equal={e1 == e2 == 0.0}", flush=True)
    del got, got_r

    # the two-antenna link through the user's entry point, launches counted
    _reset_launches()
    torch.cuda.synchronize()
    d34 = cdd_link(cfg_c, data, 34.0, 9)
    torch.cuda.synchronize()
    run = _launches()
    launches["tx_cdd"] = run["tx_cdd"]
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

    # the superseded receivers, each launched once with the counters reset
    fs, n = cfg.preamble_len + cfg.cp_len, cfg.block_len
    nflat = noisy.reshape(Bc, -1)
    chan = fused._rx_receiver_plain(cfg, nflat, 0, "conv")[0]
    frames = noisy[..., fs : fs + n].contiguous()
    fflat, chan3 = frames.reshape(Bc, -1), chan.reshape(Bc, 2, n)
    amp = 2.0**-0.5
    kern = {
        "rx_core": lambda: fused.rx_core_fused(cfg, frames, chan3),
        "rx_ic": lambda: fused.rx_ic_fused(cfg, frames, chan3),
        "rx_full": lambda: fused.rx_full_fused(cfg, noisy),
        "rx_hybrid": lambda: fused.rx_receiver_hybrid(cfg, noisy),
    }
    plain = {
        "rx_core": lambda: fused._rx_variant_plain("rx_core", cfg, fflat, chan, 0, amp),
        "rx_ic": lambda: fused._rx_variant_plain("rx_ic", cfg, fflat, chan, 2, amp),
        "rx_full": lambda: fused._rx_variant_plain("rx_full", cfg, nflat, None, 2, amp),
        "rx_hybrid": lambda: fused._rx_variant_plain("rx_hybrid", cfg, nflat, None, 2, amp),
    }
    depth = {"rx_core": 0, "rx_ic": 2, "rx_full": 2, "rx_hybrid": 2}
    _reset_launches()
    torch.cuda.synchronize()
    outs = {key: fn() for key, fn in kern.items()}
    torch.cuda.synchronize()
    run = _launches()
    parts = []
    for key, out in outs.items():
        launches[key] = run[key]
        if run[key] != fused.variant_launches(key, depth[key]):
            failures.append(f"kernel {key}: {run[key]} launches, not "
                            f"{fused.variant_launches(key, depth[key])}")
        ref_chan, ref_sym = plain[key]()
        if key == "rx_hybrid":
            ec = _max_abs(out[0].reshape(Bc, -1), ref_chan)
            parts.append(check(f"{key}:chan", ec, TOL["chan"]))
            out = out[1]
        else:
            ec = 0.0
        es = _max_abs(out.reshape(Bc, -1), ref_sym)
        err[key] = max(ec, es)
        parts.append(check(f"{key}:symbols", es, TOL["symbols"]))
        if not bool(torch.isfinite(out).all()):
            failures.append(f"{key}: non-finite symbols")
    print(f"[9 check] B={Bc} launches={ {k: run[k] for k in kern} } " + " ".join(parts),
          flush=True)
    del outs

    # each stage of each superseded receiver, and rx_core's two products as
    # six torch.mm (TF32 off): the yardstick of a part, not of the function
    inputs = {"rx_core": (fflat, chan), "rx_ic": (fflat, chan), "rx_full": (nflat, None),
              "rx_hybrid": (nflat, None)}
    for key, (x, c) in inputs.items():
        names, ms = _stage_ms(
            lambda ev, key=key, x=x, c=c: fused._rx_variant_cuda(key, cfg, x, c, depth[key], amp,
                                                                 events=ev),
            fused._variant_plan(key, depth[key]))
        print(f"[9 stages] {key} B={Bc} ic={depth[key]}: "
              + " ".join(f"{nm} {t:.3f}" for nm, t in zip(names, ms))
              + f" = {sum(ms):.3f} ms ({card})", flush=True)
    k = fused._kernel_consts(cfg, dev)
    y = fused._rx_variant_plain("rx_core", cfg, fflat, chan, 0, amp)[1]  # any (B, 2N) rows
    mm_args = []
    for x, g in ((fflat, k["F_G"]), (y, k["Bfd_G"])):
        xr, xi = x[:, :n].contiguous(), x[:, n:].contiguous()
        mm_args += [(xr, g[:n]), (xi, g[n : 2 * n]), (xr + xi, g[2 * n :])]
    mm_ms = _time_ms(torch, lambda: [torch.mm(a, w) for a, w in mm_args])
    times["rx_core_mm"] = mm_ms
    print(f"[9 library] rx_core's two Gauss products as six torch.mm ({Bc}, {n}) @ ({n}, "
          f"{n}), TF32 off: {mm_ms:.3f} ms (cuBLAS's SGEMM; no ZF, adds or intermediates) "
          f"({card})", flush=True)
    del y, mm_args

    # times (plain, kernel, kernel, plain)
    runs = {"tx_cdd": (lambda: fused.tx_cdd_fused(cfg_c, data),
                       lambda: fused._tx_cdd_plain(cfg_c, flat))}
    runs.update({key: (kern[key], plain[key]) for key in kern})
    for key, (fn_k, fn_p) in runs.items():
        k_ms, p_ms, ks, ps = _timed(torch, fn_k, fn_p)
        times[key] = (k_ms, p_ms)
        print(f"[9 time] {key}: kernel {ks} ms, plain {ps} ms (B={Bc}, {card})", flush=True)
    return launches, err, times


def _chain_library(torch, variant: str, x, cw):
    """The chain as PyTorch's own calls, the yardstick, the same products in
    the same order: three torch.mm with TF32 off (f32: cuBLAS's SGEMMs),
    three torch.mm with float32 output (bf16), three torch._int_mm with
    torch-op int8 quantization between (int8)."""
    from gfdm_tpu_torch.benchmarks.chain_int8 import int_mm_chain
    from gfdm_tpu_torch.kernels import chain

    if variant == "f32":
        with chain._no_tf32(x.device):
            return torch.mm(torch.mm(torch.mm(x, cw.w[0]), cw.w[1]), cw.w[2])
    if variant == "int8":
        return int_mm_chain(x, cw)
    a = x
    for w in cw.w:
        a = torch.mm(a.to(torch.bfloat16), w, out_dtype=torch.float32)
    return a


def _chain_phase(torch, dev, card, check, failures):
    """Phase 10: the link's GEMM chain in f32, bf16 and int8. Returns the
    kernels' launches on the main path, max errors against the plain
    versions, and (kernel, plain, library) ms."""
    from gfdm_tpu_torch.benchmarks import int8_gauss as bench
    from gfdm_tpu_torch.kernels import chain

    weights, x_np, scales = bench.make_inputs(B_CHAIN, 2)
    x = torch.from_numpy(x_np).to(dev)
    cws = {v: chain.chain_weights_from_numpy(weights, v).to(dev) for v in chain.VARIANTS}
    _reset_launches()
    torch.cuda.synchronize()
    outs = {v: bench.chain_step(x, scales[1], cws[v]) for v in chain.VARIANTS}
    torch.cuda.synchronize()
    run = _launches()
    launches = {f"chain_{v}": run[f"chain_{v}"] for v in chain.VARIANTS}
    for v, n in CHAIN_LAUNCHES.items():
        if launches[f"chain_{v}"] != n:
            failures.append(f"chain_{v}: {launches[f'chain_{v}']} launches on the main "
                            f"path, expected {n}")
    print(f"[10 main] B={B_CHAIN} chain step in each mode: launches={launches}", flush=True)
    xs = x * float(scales[1])  # the main path's input
    w64 = [torch.from_numpy(np.asarray(w, dtype=np.float64)).to(dev) for w in weights]
    ref64 = xs.double() @ w64[0] @ w64[1] @ w64[2]
    del w64
    err, times = {}, {}
    for v in chain.VARIANTS:
        got, cw = outs[v], cws[v]
        plain = chain._chain_plain(xs, cw)
        if tuple(got.shape) != (B_CHAIN, 1152) or not bool(torch.isfinite(got).all()):
            failures.append(f"chain_{v}: outputs shape {tuple(got.shape)} / not finite")
        err[f"chain_{v}"] = _max_abs(got, plain)
        rel = err[f"chain_{v}"] / float(plain.abs().max())
        rel64 = float((got.double() - ref64).abs().max() / ref64.abs().max())
        if v == "int8":
            part = check("int8:values_differing", float((got != plain).sum()), 0.0)
        else:
            part = check(f"{v}:rel", rel, CHAIN_TOL[v])
        lib = _chain_library(torch, v, xs, cw)
        print(f"[10 check] chain_{v} vs plain max_abs={err[f'chain_{v}']:.3e} rel={rel:.3e} "
              f"{part} | rel-err vs float64 chain: kernel {rel64:.3e} | library vs plain "
              f"{float((lib - plain).abs().max() / plain.abs().max()):.3e}", flush=True)
        del plain, lib
    del outs, ref64
    for v in chain.VARIANTS:
        cw = cws[v]
        k_ms, p_ms, ks, ps = _timed(torch, lambda: chain.gemm_chain(xs, cw),
                                    lambda: chain._chain_plain(xs, cw))
        lib_ms = _time_ms(torch, lambda: _chain_library(torch, v, xs, cw))
        times[f"chain_{v}"] = (k_ms, p_ms, lib_ms)
        bound_ms, bound_by = _bound(f"chain_{v}", None, B_CHAIN)
        ops = _work(f"chain_{v}", None, B_CHAIN)[0]
        print(f"[10 time] chain_{v}: kernel {ks} ms = {ops / (k_ms * 1e-3) / 1e12:.1f} "
              f"TF(OP)/s, plain {ps} ms, library {lib_ms:.3f} ms, bound {bound_ms:.3f} ms "
              f"({bound_by}) = {bound_ms / k_ms:.1%} of it (B={B_CHAIN}, {card})", flush=True)
    # the int8 call launch by launch, and PyTorch's int8 GEMM alone on
    # operands quantized beforehand: the yardstick of a part
    from gfdm_tpu_torch.benchmarks.chain_int8 import quantized_operands

    cw = cws["int8"]
    names = chain.INT8_LAUNCHES
    _names, ms = _stage_ms(lambda ev: chain._chain_cuda(xs, cw, events=ev),
                           [(n, None, 0) for n in names])
    cl = chain.int8_clusters(dev)
    print(f"[10 stages] chain_int8 B={B_CHAIN}: " + " ".join(f"{n} {t:.3f}" for n, t in
                                                             zip(names, ms))
          + f" = {sum(ms):.3f} ms; stages 1-2 as {cl['active_clusters']} clusters of "
          f"{cl['cluster']} CTAs at once ({card})", flush=True)
    qs = quantized_operands(xs, cw)
    pre_ms = _time_ms(torch, lambda: [torch._int_mm(q, w) for q, w in zip(qs, cw.w)])
    times["chain_int8_int_mm"] = pre_ms
    print(f"[10 library] chain_int8: torch._int_mm x3 on operands quantized beforehand "
          f"{pre_ms:.3f} ms (the GEMMs alone); with torch-op quantization between "
          f"{times['chain_int8'][2]:.3f} ms (the function, library_ms) (B={B_CHAIN}, {card})",
          flush=True)
    del qs
    cw = cws["f32"]
    md_ms = _time_ms(torch, lambda: torch.linalg.multi_dot([xs, *cw.w]))
    print(f"[10 note] chain_f32: torch.linalg.multi_dot {md_ms:.3f} ms, not a yardstick: it "
          f"reassociates (W1 W2 W3 first, then one GEMM over the batch), 30% of the chain's "
          f"operations (B={B_CHAIN}, {card})", flush=True)
    return launches, err, times


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


def _span_ms(torch, fn, iters: int = 3) -> tuple[float, float]:
    """(host ms to enqueue ``fn``, ms from the first event to the last on
    the card) a call, after a warm-up: where the two are close, the host's
    launches set the pace."""
    fn()
    torch.cuda.synchronize()
    host = span = 0.0
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host += time.perf_counter() - t0
        stop.record()
        stop.synchronize()
        span += start.elapsed_time(stop)
    return host * 1e3 / iters, span / iters


def _decoder_stages(torch, rx, data, snr, card) -> None:
    """[11 stages]: the decoder's parts at the service's slots, each timed
    alone (host enqueue and event span): the LLRs and deinterleave, the
    Viterbi kernel, and beside it its plain version's parts on the card
    (the branch pattern sums, the forward ACS steps, the traceback)."""
    from gfdm_tpu_torch import coding
    from gfdm_tpu_torch.kernels import viterbi
    from gfdm_tpu_torch.ops import softbits

    n, T = data.shape[0], rx.fec_info_bits + coding.CONV_TAIL_BITS
    k = next(kk for kk in (4, 3, 2) if T % kk == 0)
    nv = 1.0 / torch.clamp_min(snr, 1e-6)

    def llr():
        return softbits.maxlog_llrs_planar(data, rx._fec_points, nv[:, None]).reshape(
            n, -1).index_select(1, rx._fec_inv)

    lp = llr().reshape(n, T, 2).contiguous()
    lt = lp.reshape(n, T // k, 2 * k).transpose(0, 1)
    pat = coding._pattern_sums(lt)
    idx = coding.device_const(("pattern", k), data.device, lambda: coding._pattern_index(k))
    pm0 = coding._initial_metrics(n, data.device)
    decs = coding._forward(pat, idx, k, pm0)[1]
    state = torch.zeros(n, dtype=torch.int64, device=data.device)
    parts = (("llrs+deinterleave", llr), ("viterbi kernel", lambda: viterbi.decode(lp, k)),
             ("plain: pattern sums", lambda: coding._pattern_sums(lt)),
             (f"forward ({T // k} steps)", lambda: coding._forward(pat, idx, k, pm0)),
             (f"traceback ({T // k - 1} steps)", lambda: coding._traceback(decs, state, k)))
    line = []
    for name, fn in parts:
        host, span = _span_ms(torch, fn)
        line.append(f"{name} host {host:.3f} / card {span:.3f} ms")
    print(f"[11 stages] decoder at {n} slots, radix-{1 << k}: " + "; ".join(line)
          + f" ({card})", flush=True)


def _viterbi_llrs(batch: int, T: int, seed: int, snr_db: float = 1.0) -> np.ndarray:
    """(batch, T, 2) float32 LLRs of random zero-terminated codewords in
    AWGN at ``snr_db`` Es/N0 (4 / variance times the received value)."""
    from gfdm_tpu_torch.coding import CONV_TAIL_BITS, conv_encode

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, T - CONV_TAIL_BITS)).astype(np.uint8)
    var = 10 ** (-snr_db / 10)
    y = 1.0 - 2.0 * conv_encode(bits) + np.sqrt(var / 2) * rng.standard_normal((batch, 2 * T))
    return (2.0 * y / (var / 2)).astype(np.float32).reshape(batch, T, 2)


def _viterbi_times(torch, dev, card, check):
    """[11 time] the Viterbi kernel alone at N_CHUNKS codewords of each
    VITERBI_T (radix 16) on noisy LLRs, its rows differing from the plain
    version's on the CPU, and kernel and plain (the torch-op decoder on the
    card) times in turns. Returns (rows differing, times) by key."""
    from gfdm_tpu_torch.kernels import viterbi

    err, times = {}, {}
    for T in VITERBI_T:
        key = f"viterbi_t{T}"
        cpu = torch.from_numpy(_viterbi_llrs(N_CHUNKS, T, seed=T))
        lp = cpu.to(dev)
        got = viterbi.decode(lp, 4).cpu()
        err[key] = float((got != viterbi._decode_plain(cpu, 4)).any(dim=1).sum())
        k_ms, p_ms, ks, ps = _timed(torch, lambda: viterbi.decode(lp, 4),
                                    lambda: viterbi._decode_plain(lp, 4))
        times[key] = (k_ms, p_ms)
        print(f"[11 time] viterbi B={N_CHUNKS} T={T} radix 16: kernel {ks} ms, plain (torch "
              f"ops on the card) {ps} ms "
              + check(f"viterbi[T={T}]:rows_differing_vs_cpu", err[key], 0.0)
              + f" ({card})", flush=True)
    return err, times


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
    _reset_launches()
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
    run = _launches()
    pp.DETECT_IMPL = default_impl
    return outs, run, n_bursts


def _coded_phase(torch, cfg, dev, streams, card, check, failures):
    """Phase 11: the coded modem through both services (see the module
    docstring)."""
    from gfdm_tpu_torch.cli import burst_capacity_bytes, payload_to_symbols
    from gfdm_tpu_torch.coding import CONV_TAIL_BITS, conv_encode, viterbi_decode
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
    results, viterbi_launches = {}, {}
    for impl, qam in ((pp.DETECT_IMPL, "qpsk"), ("pallas2", "qpsk"), ("pallas", "qpsk"),
                      (pp.DETECT_IMPL, "qam64")):
        lcap, lpay, lnoise, snr_db = links[qam]
        outs, run, n_bursts = _coded_link(torch, cfg, dev, impl, lpay, lnoise, delay, qam)
        out = outs[0]
        name = impl if qam == "qpsk" else f"{impl},{qam}"
        ic = 4 if qam == "qam64" else 2
        found, bits = out["found"], out["bits"]
        n_info = bits.shape[1]
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
        if run["tx"] != 1 or run["rx"] != fused.rx_launches(ic):
            failures.append(f"coded path ({name}): launches {run}, expected tx 1 and rx "
                            f"{fused.rx_launches(ic)}")
        if not same:
            failures.append(f"coded path ({name}): a CRC-clean payload differs from the sent one")
        if len(set(lag.tolist())) > 1:
            failures.append(f"coded path ({name}): detections off the cycle grid {set(lag)}")
        if impl == pp.DETECT_IMPL:  # the main path's decoder launches, by trellis length
            viterbi_launches[f"viterbi_t{n_info + CONV_TAIL_BITS}"] = run["viterbi"]
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

    # 3. the decoder and the soft bits on the card against the CPU, at the
    # QPSK links' codeword (T = 468)
    n_info = results[pp.DETECT_IMPL]["bits"].shape[1]
    drng = np.random.default_rng(16)
    info = drng.integers(0, 2, (N_CHUNKS, n_info)).astype(np.uint8)
    sym = 1.0 - 2.0 * conv_encode(info).astype(np.float64)
    sd = drng.choice([0.0, 0.5**0.5, (10**0.2 / 2) ** 0.5], (N_CHUNKS, 1))
    dy = np.clip(np.round(4.0 * (sym + sd * drng.standard_normal(sym.shape)) * 8) / 8,
                 -16.0, 16.0).astype(np.float32)
    dy[::64] = 0.0  # all-zero rows: every candidate ties
    parts = []
    for mode in ("auto", "radix", "full", "sm", "windowed"):
        card_bits = viterbi_decode(torch.from_numpy(dy).to(dev), n_info, mode).cpu()
        cpu_bits = viterbi_decode(torch.from_numpy(dy), n_info, mode)
        parts.append(check(f"{mode}:rows_differing", float(
            (card_bits != cpu_bits).any(dim=1).sum()), 0.0))
    print(f"[11 check] viterbi card vs CPU on dyadic LLRs ({N_CHUNKS} x {2 * (n_info + 6)}, "
          f"{N_CHUNKS // 64} all-zero rows): " + " ".join(parts), flush=True)
    out = results[pp.DETECT_IMPL]
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
    u1, c1, c2, u2 = (_time_ms(torch, fn) for fn in (
        lambda: rx_plain._step(chunks), lambda: rx._step(chunks),
        lambda: rx._step(chunks), lambda: rx_plain._step(chunks)))
    coded_ms, plain_ms = (c1 + c2) / 2, (u1 + u2) / 2
    dec_ms = _time_ms(torch, lambda: rx._fec_decode(data, snr))
    llrs = softbits.maxlog_llrs_planar(data, rx._fec_points, (1.0 / torch.clamp_min(
        snr, 1e-6))[:, None]).reshape(N_CHUNKS, -1).index_select(1, rx._fec_inv)
    vit_ms = _time_ms(torch, lambda: viterbi_decode(llrs, n_info))
    n_coded = _launch_counts(torch, lambda: rx._step(chunks))
    n_plain = _launch_counts(torch, lambda: rx_plain._step(chunks))
    n_dec = _launch_counts(torch, lambda: rx._fec_decode(data, snr))
    busy = _device_busy(torch, lambda: rx._step(chunks))
    print(f"[11 time] coded step {c1:.3f}/{c2:.3f} ms = {samples / (coded_ms / 1e3):.4e} "
          f"coded samples/s, uncoded step {u1:.3f}/{u2:.3f} ms = "
          f"{samples / (plain_ms / 1e3):.4e} samples/s (DETECT_IMPL={pp.DETECT_IMPL}, "
          f"{N_CHUNKS} chunks x {CHUNK_LEN}, friendly stream seed 0, {card})", flush=True)
    print(f"[11 time] decoder (LLRs + deinterleave + Viterbi) {dec_ms:.3f} ms = "
          f"{dec_ms / coded_ms:.1%} of the coded step, of it the Viterbi decoder alone "
          f"{vit_ms:.3f} ms; coded - uncoded {coded_ms - plain_ms:.3f} ms; "
          + ("device busy not measured" if busy is None else
             f"coded step device busy {busy[0]:.3f} ms (idle {1 - busy[0] / coded_ms:.1%})")
          + f" ({card})", flush=True)
    _decoder_stages(torch, rx, data, snr, card)
    fmt = lambda c: "not measured" if c is None else f"{c[0]} kernels, {c[1]} launch calls"  # noqa: E731
    print(f"[11 launches] coded step {fmt(n_coded)}; uncoded step {fmt(n_plain)}; decoder "
          f"alone {fmt(n_dec)} (torch.profiler, one step after a warm-up, {card})", flush=True)
    del chunks, coded, data, snr, llrs

    # the transmit service's step at N_CHUNKS bursts
    tx = StreamingTransmitter(cfg, cycle_samples=CHUNK_LEN, device=dev)
    syms = streams["friendly"][2][:N_CHUNKS]
    dev_syms = torch.from_numpy(syms).to(dev)
    ref = fused._tx_frame_plain(cfg, dev_syms.reshape(N_CHUNKS, -1), 0)
    got = tx.step(syms)
    e = float(np.abs(got.reshape(N_CHUNKS, -1) - ref.cpu().numpy()).max())
    tx.step(syms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        tx.step(syms)
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    dev_ms = _time_ms(torch, lambda: tx._tx(dev_syms))
    print(f"[11 time] StreamingTransmitter.step B={N_CHUNKS}: host {host_ms:.3f} ms (copies "
          f"in and out), device {dev_ms:.3f} ms (the Tx kernel and the scale), "
          + check("vs plain", e, TOL["tx"]) + f" bit_equal={e == 0.0} ({card})", flush=True)

    # the Viterbi kernel alone at the coded services' trellis lengths; the
    # launches are the main path's (the QPSK and 64-QAM services links above)
    err, times = _viterbi_times(torch, dev, card, check)
    missing = sorted(set(times) - set(viterbi_launches))
    if missing:
        failures.append(f"no services link ran the decoder at {missing}")
    return viterbi_launches, err, times


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
    """CUDA-event ms of the loop's device work, (Tx, receive, busy): the Tx
    kernel over every batch, the receive step over every super-batch (one
    timed, scaled), and one step's device busy ms with its receiver part."""
    tx_ms = _time_ms(torch, lambda: tx._tx(payload_dev)) * (N_LIVE // LIVE_TX_BATCH)
    t = torch.from_numpy(chunks).to(rx.device)
    rx_ms = _time_ms(torch, lambda: rx._step(t)) * (N_LIVE / chunks.shape[0])
    busy = _device_busy(torch, lambda: rx._step(t))
    return tx_ms, rx_ms, busy


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
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tx.serve(batches(), push)
    push.push(np.zeros((2, halo), np.float32))  # flush the tail chunk
    tx_wall = time.perf_counter() - t0
    pull = _Timed(ring, keep=True)
    default_impl = pp.DETECT_IMPL
    pp.DETECT_IMPL = "pallas2"
    rx, got, rx_wall = _live_rx(torch, cfg, dev, pull)
    launches = _launches()
    line = _live_checks(cfg, "ring", got, payload, tx.cycle_samples, launches, "detect_lean",
                        check)
    if tx.cycle_samples != CHUNK_LEN or rx.stats.dropped_ring:
        failures.append(f"ring loopback: cycle {tx.cycle_samples}, dropped {rx.stats.dropped_ring}")
    print(f"[12 live] ring loopback B={N_LIVE} DETECT_IMPL=pallas2 {line} "
          f"dropped={rx.stats.dropped_ring}", flush=True)
    tx_ms, rx_ms, busy = _live_device_ms(torch, tx, rx, torch.from_numpy(
        payload[:LIVE_TX_BATCH]).to(dev), pull.kept[0])
    pp.DETECT_IMPL = default_impl
    loop_s = tx_wall + rx_wall
    print(f"[12 time] ring loopback wall: Tx serve {tx_wall * 1e3:.1f} ms (of it the ring "
          f"push {push.seconds * 1e3:.1f}), Rx serve {rx_wall * 1e3:.1f} ms (of it the ring "
          f"pull {pull.seconds * 1e3:.1f}); live loop {samples / loop_s:.4e} samples/s; card: "
          f"Tx kernel {tx_ms:.3f} ms, receive steps {rx_ms:.3f} ms (CUDA events, "
          f"{N_LIVE // LIVE_RX_MAX} steps of {LIVE_RX_MAX} chunks), "
          + ("device busy not measured" if busy is None else
             f"a step's device busy {busy[0]:.3f} ms, receiver kernels {busy[1]:.3f}")
          + f"; card share of the loop {(tx_ms + rx_ms) / (loop_s * 1e3):.2%} ({card})",
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
    _reset_launches()
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
    launches = _launches()
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
    cuda_ms = _time_ms(torch, lambda: receiver.receive_stream(cfg, s_dev), iters=3)
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
        rs_ms = _time_ms(torch, lambda: receive_stream(cfg, s_dev, ic_iterations=ic,
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
    _reset_launches()

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
    point_ms = _time_ms(torch, lambda: one(9.0, bits_dev, noise), iters=5)
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
    coded_ms = _time_ms(torch, lambda: fn(3.0, cb_dev, noise), iters=3)
    dec_ms = _time_ms(torch, lambda: coded.viterbi_decode(llrs, n_info), iters=3)
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
        ms = _time_ms(torch, lambda: legacy.modulate_oversampled(cfg, grid_dev, fft_len))
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
    launches = {k: v for k, v in _launches().items() if v}
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
        _reset_launches()
        o2 = two.step(chunks)
        run = _launches()
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
        ms2 = _time_ms(torch, lambda: two._step(dev_chunks))
        ms1 = _time_ms(torch, lambda: one._step(dev_chunks))
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

    # rows 12-13 against their plain versions at the sub-chunk windows
    windows = dev_chunks.unfold(-1, sub + halo, sub).transpose(1, 2).reshape(-1, 2, sub + halo)
    label = f"B={windows.shape[0]},T={sub + halo},n_valid={sub}"
    _check_front(cfg, windows, label, check, limit=sub, tag="14")
    _check_lean(torch, cfg, windows, label, check, failures, limit=sub, tag="14")


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
        _reset_launches()
        t0 = time.perf_counter()
        try:
            res[name] = fn()
        except RuntimeError as exc:  # the example's own check
            failures.append(f"example {name}: {exc}")
            continue
        wall = time.perf_counter() - t0
        run = _launches()
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
    _reset_launches()
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
    _reset_launches()
    res = dryrun_multichip(PAR_DP * PAR_SP, device=dev)
    run = _launches()
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
    from gfdm_tpu_torch.entry import (_dynamic_range_chunks, entry, large_k_config,
                                      planar_payload, service_stream)
    from gfdm_tpu_torch.kernels import cuda_lib, fused
    from gfdm_tpu_torch.ops.planar_pipeline import evm, link_step_planar

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    card = _card_line()
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
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"[2 build] {info['seconds']:.1f} s nvcc, cached={info['cached']}, "
          f"{info['path']}", flush=True)
    for ln in regs:
        print(f"    ptxas: {ln}")

    # 3. kernels vs plain versions on the same CUDA inputs
    cfg = GfdmConfig()
    cfg_s = GfdmConfig(cyclic_shifts=(0, 4))
    data = torch.from_numpy(planar_payload(cfg, B, seed=0)).to(dev)
    flat = data.reshape(B, -1)
    err = {"tx": 0.0, "rx": 0.0, "link": 0.0}
    parts = []
    small = data[: min(B, N_RAGGED_LINK)]
    # n_data = 130: an xi plane 520 bytes into a row, a ragged k-tile
    cfg_u = GfdmConfig(subcarriers=32, active_subcarriers=26, timeslots=5, cp_len=8,
                       cs_len=8, cyclic_shifts=(0, 4))
    data_u = torch.from_numpy(planar_payload(cfg_u, N_RAGGED_LINK, seed=2)).to(dev)
    tx_cases = [(cfg_s, small, si, "") for si in range(len(cfg_s.cyclic_shifts))]
    tx_cases += [(cfg_u, data_u, si, "n_data=130,") for si in range(len(cfg_u.cyclic_shifts))]
    for c_tx, d_tx, si, tag in tx_cases:
        got = fused.tx_frame_fused(c_tx, d_tx, shift_index=si)
        ref = fused._tx_frame_plain(c_tx, d_tx.reshape(d_tx.shape[0], -1), si)
        e = _max_abs(got.reshape(ref.shape), ref)
        err["tx"] = max(err["tx"], e)
        parts.append(check(f"tx[{tag}B={d_tx.shape[0]},shift={c_tx.cyclic_shifts[si]}]",
                           e, TOL["tx"]))
    bursts = fused.tx_frame_fused(cfg, data)
    e = _max_abs(bursts.reshape(B, -1), fused._tx_frame_plain(cfg, flat, 0))
    err["tx"] = max(err["tx"], e)
    parts.append(check(f"tx[B={B},shift=0]", e, TOL["tx"]))
    print("[3 check] " + " ".join(parts) + f" bit_equal={err['tx'] == 0.0}", flush=True)
    del data_u

    noisy = _noisy(torch, bursts, 1)
    noisy_flat = noisy.reshape(B, -1)
    sent = noisy.clone()
    n_cnr = fused._met_layout(cfg)[0]
    for mode in ("conv", "matmul"):
        parts = []
        for nb in (B, N_RAGGED_LINK):
            before = fused.LAUNCHES["rx"]
            chan, sym, met = fused.rx_receiver_fused(cfg, noisy[:nb], ic_mode=mode)
            n_launch = fused.LAUNCHES["rx"] - before
            rchan, rsym, rmet = fused._rx_receiver_plain(cfg, noisy_flat[:nb], 2, mode)
            ec = _max_abs(chan.reshape(nb, -1), rchan)
            es = _max_abs(sym.reshape(nb, -1), rsym)
            err["rx"] = max(err["rx"], ec, es)
            parts += [
                check(f"chan[B={nb}]", ec, TOL["chan"]),
                check(f"symbols[B={nb}]", es, TOL["symbols"]),
                check("snr_rel", _max_rel(met[:, 0], rmet[:, 0]), TOL["snr_rtol"]),
                check("cnr_rel", _max_rel(met[:, 1 : 1 + n_cnr], rmet[:, 1 : 1 + n_cnr]),
                      TOL["cnr_rtol"]),
                check("pad", float(met[:, 1 + n_cnr :].abs().max()), 0.0),
                check("launches!=plan", float(n_launch != fused.rx_launches(2)), 0.0),
            ]
            del chan, sym, met, rchan, rsym, rmet
        print(f"[3 check] rx[{mode}] " + " ".join(parts), flush=True)
    if not torch.equal(noisy, sent):
        failures.append("rx_receiver_fused wrote into its bursts")
    del sent
    ragged = data[:N_RAGGED_LINK]
    for mode in ("conv", "matmul"):
        d_hat, _snr, _evm = fused.link_single_fused(cfg, data, ic_mode=mode)
        ref, _met = fused._link_single_plain(cfg, flat, 2, mode)
        e = _max_abs(d_hat.reshape(B, -1), ref)
        d_r = fused.link_single_fused(cfg, ragged, ic_mode=mode)[0]
        e_r = _max_abs(d_r.reshape(N_RAGGED_LINK, -1),
                       fused._link_single_plain(cfg, flat[:N_RAGGED_LINK], 2, mode)[0])
        err["link"] = max(err["link"], e, e_r)
        print(f"[3 check] link[{mode}] " + check(f"data[B={B}]", e, TOL["data"]) + " "
              + check(f"data[B={N_RAGGED_LINK}]", e_r, TOL["data"]), flush=True)
        del d_hat, ref, d_r

    # 3. detection kernels vs plain on the service's friendly chunks
    streams = {
        name: service_stream(cfg, N_CHUNKS, CHUNK_LEN, 20.0, impaired,
                             np.random.default_rng(0))
        for name, impaired in (("friendly", False), ("impaired", True))
    }
    friendly_dev = torch.from_numpy(streams["friendly"][0]).to(dev)
    ragged = friendly_dev[:N_RAGGED, :, : friendly_dev.shape[-1] - RAGGED_TRIM]
    ragged = ragged.contiguous()
    dynamic = torch.from_numpy(_dynamic_range_chunks(cfg, CHUNK_LEN,
                                                     np.random.default_rng(11))).to(dev)
    err["detect_front"] = err["detect_lean"] = 0.0
    for label, s_in in ((f"B={N_CHUNKS},T={friendly_dev.shape[-1]}", friendly_dev),
                        (f"B={N_RAGGED},T={ragged.shape[-1]}", ragged),
                        (f"B={dynamic.shape[0]},60dB_steps", dynamic)):
        err["detect_front"] = max(err["detect_front"],
                                  _check_front(cfg, s_in, label, check))
        err["detect_lean"] = max(err["detect_lean"],
                                 _check_lean(torch, cfg, s_in, label, check, failures))

    # 4. the main path at full batch, through the user's entry points
    step, (example,) = entry(dev)
    _d, _s, evm_example = step(example)
    _reset_launches()
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

    # 5. times at the main path's shapes (plain, kernel, kernel, plain)
    runs = {
        "tx": (lambda: fused.tx_frame_fused(cfg, data),
               lambda: fused._tx_frame_plain(cfg, flat, 0)),
        "rx": (lambda: fused.rx_receiver_fused(cfg, noisy, ic_mode="conv"),
               lambda: fused._rx_receiver_plain(cfg, noisy_flat, 2, "conv")),
        "rx_matmul": (lambda: fused.rx_receiver_fused(cfg, noisy, ic_mode="matmul"),
                      lambda: fused._rx_receiver_plain(cfg, noisy_flat, 2, "matmul")),
        "link": (lambda: fused.link_single_fused(cfg, data, ic_mode="matmul"),
                 lambda: fused._link_single_plain(cfg, flat, 2, "matmul")),
        "link_conv": (lambda: fused.link_single_fused(cfg, data, ic_mode="conv"),
                      lambda: fused._link_single_plain(cfg, flat, 2, "conv")),
        "link_bf16": (lambda: fused.link_single_fused(cfg, data, ic_mode="matmul",
                                                      dtype_name="bfloat16"),
                      lambda: fused._link_single_plain(cfg, flat, 2, "matmul",
                                                       dtype_name="bfloat16")),
    }
    times = {}
    for name, (kern, plain) in runs.items():
        k_ms, p_ms, ks, ps = _timed(torch, kern, plain)
        times[name] = (k_ms, p_ms)
        rate = B * cfg.frame_len / (k_ms / 1e3)
        print(f"[5 time] {name}: kernel {ks} ms, plain {ps} ms, kernel {rate:.4e} "
              f"samples/s (B={B}, {card})", flush=True)
        if name == "tx":
            _tx_yardstick(torch, cfg, flat, k_ms, card)
    _link_stage_times(torch, cfg, flat, card)
    _rx_stage_times(cfg, noisy_flat, card, "5")

    # 6. the streaming receive service; the receiver's stages at its 4,096
    # slots (the friendly stream's)
    svc_launches, det_times = _service_phase(torch, cfg, dev, streams, card,
                                             check, failures)
    _rx_stage_times(cfg, noisy_flat[:N_CHUNKS], card, "6")
    launches.update(svc_launches)
    times.update(det_times)

    # 7. the large-K factored path
    lk_launches, lk_err, lk_times, row6 = _large_k_phase(torch, dev, card, check, failures)
    launches.update(lk_launches)
    times.update(lk_times)
    for key, e in lk_err.items():
        err[key] = max(err.get(key, 0.0), e)

    # 8. receiver and link options, the service at qam16 / qam64
    opt_err, svc_rx = _options_phase(torch, cfg, dev, card, check, failures)
    for key, e in opt_err.items():
        err[key] = max(err[key], e)

    # 9. the CDD transmitter and link, the superseded receivers
    cv_launches, cv_err, cv_times = _cdd_variants_phase(torch, cfg, dev, data, noisy, card,
                                                        check, failures)
    launches.update(cv_launches)
    err.update(cv_err)
    times.update(cv_times)

    # 10. the link's GEMM chain at f32, bf16 and int8
    ch_launches, ch_err, ch_times = _chain_phase(torch, dev, card, check, failures)
    launches.update(ch_launches)
    err.update(ch_err)
    times.update(ch_times)

    # 11. the coded modem through the transmit and receive services; the
    # Viterbi kernel alone
    vit_launches, vit_err, vit_times = _coded_phase(torch, cfg, dev, streams, card, check,
                                                    failures)
    launches.update(vit_launches)
    err.update(vit_err)
    times.update(vit_times)

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
    # the bound at each kernel's timed shapes
    lk = {K: large_k_config(K) for K in (K_FULL, K_ESTIMATOR)}
    shapes = {
        "tx": (cfg, B, {}), "tx_cdd": (GfdmConfig(cyclic_shifts=(0, 2)), B, {"ports": 2}),
        "rx": (cfg, B, {}), "link": (cfg, B, {"ic_mode": "matmul"}),
        "detect_front": (cfg, N_CHUNKS, {"T": CHUNK_LEN + cfg.frame_len + cfg.cp_len,
                                         "n_valid": CHUNK_LEN}),
        "detect_lean": (cfg, N_CHUNKS, {"T": CHUNK_LEN + cfg.frame_len + cfg.cp_len,
                                        "n_valid": CHUNK_LEN}),
        "tx_factored": (lk[K_FULL], B_LARGE_K, {}),
        "rx_factored": (lk[K_ESTIMATOR], B_LARGE_K, {}),
        "rx_estimate": (lk[K_ESTIMATOR], B_LARGE_K, {}),
        "rx_factored_chan": (lk[K_FULL], B_LARGE_K, {}),
        "rx_core": (cfg, B, {}), "rx_ic": (cfg, B, {}), "rx_full": (cfg, B, {}),
        "rx_hybrid": (cfg, B, {}),
        **{f"chain_{v}": (None, B_CHAIN, {}) for v in ("f32", "bf16", "int8")},
        **{f"viterbi_t{T}": (None, N_CHUNKS, {"T": T}) for T in VITERBI_T},
    }
    kernels = []
    for key, (name, source, replaces) in SOURCES.items():
        kcfg, kb, kw = shapes[key]
        bound_ms, bound_by = _bound(key, kcfg, kb, **kw)
        extra, note = {}, ""
        if key == "rx":  # restated as the link's; fp32 FMA and FP64 beside it
            extra["fma_bound_ms"] = bound_ms
            bound_ms, bound_by, inter_ms = _rx_bound(kcfg, kb)
            mm_ms, mm_by, _ = _rx_bound(kcfg, kb, "matmul")
            f64_ms = _rx_bound(kcfg, kb, fp64=True)[0]
            note = (f" (conv IC); fp32 FMA bound {extra['fma_bound_ms']:.3f} ms; FP64 tensor "
                    f"cores {f64_ms:.3f} ms; the design's intermediates {inter_ms:.3f} ms; "
                    f"matmul IC {mm_ms:.3f} ms ({mm_by}) against rx_matmul "
                    f"{times['rx_matmul'][0]:.3f} ms = {mm_ms / times['rx_matmul'][0]:.1%}")
        if key in ("tx_factored", "rx_factored", "rx_factored_chan"):  # and the direct DFT's
            extra["dft_bound_ms"], dft_by = _bound(key, kcfg, kb, direct_dft=True)
            note = (f"; with the K-point stage as the direct DFT "
                    f"{extra['dft_bound_ms']:.3f} ms ({dft_by}) = "
                    f"{extra['dft_bound_ms'] / times[key][0]:.1%}")
        if key in ("detect_front", "detect_lean"):  # the FIR's and the old count beside it
            extra["fir_bound_ms"], fir_by = _bound(key, kcfg, kb, detect_form="fir", **kw)
            extra["old_bound_ms"] = _bound(key, kcfg, kb, detect_form="old", **kw)[0]
            note = (f" (the cross-correlation as overlap-save FFTs, not run); as the direct "
                    f"FIR the kernels run {extra['fir_bound_ms']:.3f} ms ({fir_by}) = "
                    f"{extra['fir_bound_ms'] / times[key][0]:.1%}; every sum anew at every "
                    f"position {extra['old_bound_ms']:.3f} ms")
        if key == "rx_factored":  # two launches: the estimator GEMM, the receiver
            extra["launches_by_kernel"] = row6
        if key == "rx_core":  # its two products as six torch.mm: a part's yardstick
            extra["mm_yardstick_ms"] = times["rx_core_mm"]
            note = (f"; its two Gauss products as six torch.mm "
                    f"{extra['mm_yardstick_ms']:.3f} ms")
        if key == "chain_int8":  # PyTorch's int8 GEMMs alone: a part's yardstick
            extra["int_mm_yardstick_ms"] = times["chain_int8_int_mm"]
            note = (f"; torch._int_mm x3 on operands quantized beforehand "
                    f"{extra['int_mm_yardstick_ms']:.3f} ms")
        if key == "link":  # tensor-core bound; the fp32 FMA one as PRs 1-6 gave it
            extra["fma_bound_ms"] = bound_ms
            bound_ms, bound_by, inter_ms = _link_bound(kcfg, kb, **kw)
            bf_ms, bf_by, _ = _link_bound(kcfg, kb, dtype_name="bfloat16", **kw)
            note = (f"; fp32 FMA bound {extra['fma_bound_ms']:.3f} ms; the design's "
                    f"intermediates {inter_ms:.3f} ms; with bf16 stacks {bf_ms:.3f} ms "
                    f"({bf_by}) against link_bf16 {times['link_bf16'][0]:.3f} ms")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": err[key], "ms": times[key][0],
            "plain_ms": times[key][1], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": times[key][2] if len(times[key]) > 2 else None, **extra,
        })
        print(f"[bound] {key}: {bound_ms:.3f} ms ({bound_by}) at B={kb}; kernel "
              f"{times[key][0]:.3f} ms = {bound_ms / times[key][0]:.1%} of the bound{note} "
              f"({card})", flush=True)
    print(f"[8 main] service launches rx={svc_rx}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
