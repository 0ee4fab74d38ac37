#!/usr/bin/env python3
"""Run the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py    # canonical config: link B = 65,536 bursts,
                             # service 4,096 chunks x 2,048 samples

Phases, one line each (any failure exits non-zero and prints no result):

1. device  - requires CUDA; prints the card's name and power limit.
2. build   - compiles the CUDA kernels of gfdm_tpu_torch/csrc with nvcc.
3. check   - each kernel against its plain torch version on the same CUDA
             inputs: the Tx at a ragged batch and shifts (0, 4), the
             receiver on noisy bursts (AWGN 20 dB) and the one-kernel link,
             both IC modes; both detection kernels on the service's 4,096
             friendly chunks and on 37 chunks of a T that is not 128-aligned.
4. main    - the entry step (link_single_fused, matmul IC) and
             link_step_fused (Tx kernel -> receiver kernel) at full batch,
             with the launch counters reset just before; EVM against the
             plain versions and the planar torch-op link.
5. time    - each link kernel and its plain version, CUDA events after
             warm-up.
6. service - StreamingReceiver(engine="fused") on the synthetic service
             streams (entry.service_stream, seed 0): friendly (20 dB AWGN,
             one burst a chunk, k = 1) under DETECT_IMPL "pallas2" (lean
             detection kernel), "pallas" (front kernel) and "twostage"
             (torch ops); impaired (8-tap multipath, CFO up to +-0.2, 0-2
             bursts a chunk, k = 2) under "pallas" and "twostage". Each step
             runs once under torch's sync debug mode, which fails on any
             host sync inside it; then once with the launch counters reset
             just before, through StreamingReceiver.step: found fraction,
             device-step samples/s (CUDA events), launches, and on the
             friendly stream the EVM of the found slots against the sent
             payload; then the detection kernels' times and one serve()
             loop (batch 256, super-batch 1,024, pipeline depth 2).
7. large K - the factored kernels (entry.large_k_config, the crossover
             study's M = 9 configs): at K = 512, B = 4,096 the Tx kernel and
             the receiver kernel with the channel read (estimator="fast"), at
             K = 128, B = 4,096 the receiver kernel with its own dense
             estimator, each against its plain version on noisy bursts
             (AWGN 20 dB); the dense receiver and link kernels at K = 128
             (their 4-burst tile). Then, with the launch counters reset just
             before, the large-K link link_step_factored (Tx kernel ->
             torch-op estimate -> receiver kernel -> demap) at K = 512,
             B = 4,096 and the estimator="fused" link at K = 128: hard
             decisions against the payload, EVM against the plain versions'
             and the torch-op method="fast" chain's. Last, kernel vs plain
             and the link (kernels, plain versions, torch-op chain) timed at
             K = 256, 512 (B = 4,096) and 1,024 (B = 2,048), and the
             estimator="fused" receiver kernel at K = 128.

Then a JSON line of per-kernel results, the card line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
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
}
N_CHUNKS = 4096  # service batch: 8.4 M owned samples a step
CHUNK_LEN = 2048
N_RAGGED, RAGGED_TRIM = 37, 5  # chunks of T - 5 samples: not 128-aligned
SOURCES = {
    "tx": ("tx_frame_fused", "gfdm_tpu_torch/csrc/tx.cu",
           "gfdm_tpu/kernels/fused.py:1662"),
    "rx": ("rx_receiver_fused", "gfdm_tpu_torch/csrc/rx.cu",
           "gfdm_tpu/kernels/fused.py:343"),
    "link": ("link_single_fused", "gfdm_tpu_torch/csrc/link.cu",
             "gfdm_tpu/kernels/fused.py:1403"),
    "detect_front": ("detect_front_fused", "gfdm_tpu_torch/csrc/detect.cu",
                     "gfdm_tpu/kernels/detect.py:71"),
    "detect_lean": ("detect_bursts_fused", "gfdm_tpu_torch/csrc/detect.cu",
                    "gfdm_tpu/kernels/detect.py:164"),
    "tx_factored": ("tx_frame_factored", "gfdm_tpu_torch/csrc/factored.cu",
                    "gfdm_tpu/kernels/fused.py:1847"),
    "rx_factored": ("rx_receiver_factored(estimator=fused)",
                    "gfdm_tpu_torch/csrc/factored.cu", "gfdm_tpu/kernels/fused.py:849"),
    "rx_factored_chan": ("rx_receiver_factored(estimator=fast)",
                         "gfdm_tpu_torch/csrc/factored.cu",
                         "gfdm_tpu/kernels/fused.py:862"),
}
# phase 7: the crossover study's link points (K, B) and the full-width one;
# estimator="fused" runs at K = 128, where its dense (4K, 2N) E is 4.7 MB
LARGE_K = ((256, 4096), (512, 4096), (1024, 2048))
K_FULL, K_ESTIMATOR, B_LARGE_K = 512, 128, 4096


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


def _noisy(torch, bursts, seed: int, snr_db: float = 20.0):
    """bursts + AWGN at snr_db (noise drawn with numpy from ``seed``)."""
    sig_pow = float((bursts**2).sum(dim=1).mean())  # mean |x|^2 per sample
    sigma = (sig_pow / 10 ** (snr_db / 10) / 2) ** 0.5
    noise = np.random.default_rng(seed).standard_normal(tuple(bursts.shape),
                                                        dtype=np.float32)
    return bursts + sigma * torch.from_numpy(noise).to(bursts.device)


def _reset_launches() -> None:
    from gfdm_tpu_torch.kernels import detect, fused

    for counts in (fused.LAUNCHES, detect.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _launches() -> dict:
    from gfdm_tpu_torch.kernels import detect, fused

    return {**fused.LAUNCHES, **detect.LAUNCHES}


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


def _check_front(cfg, s, label, check) -> float:
    """Kernel A through its wrapper against its plain version."""
    from gfdm_tpu_torch.kernels import detect

    n_valid = min(s.shape[-1] - 2 * cfg.subcarriers, CHUNK_LEN)
    got = detect.detect_front_fused(cfg, s, CHUNK_LEN)
    ref = detect._detect_front_plain(cfg, s, n_valid)
    parts, e = _check_traces(got, ref, ("gated", "ac", "energy", "ic"), check)
    print(f"[3 check] detect_front[{label}] max_abs={e:.3e} (traces: excess over "
          f"atol {TOL['trace_atol']} + rtol {TOL['trace_rtol']}) " + " ".join(parts),
          flush=True)
    return e


def _check_lean(torch, cfg, s, label, check, failures) -> float:
    """Kernel B's traces and its detection dict against the plain versions."""
    from gfdm_tpu_torch.kernels import detect

    n_valid = min(s.shape[-1] - 2 * cfg.subcarriers, CHUNK_LEN)
    got_tr = detect._detect_lean_cuda(cfg, s, n_valid)
    ref_tr = detect._detect_lean_plain(cfg, s, n_valid)
    parts, e = _check_traces(got_tr, ref_tr, ("gated", "ic"), check)
    got = detect.detect_bursts_fused(cfg, s, CHUNK_LEN)
    ref = detect._lean_epilogue(cfg, s, *ref_tr)
    n_diff = int((got["start"] != ref["start"]).sum())
    parts.append(check("start_mismatch", float(n_diff), 0.0))
    for key in ("cfo", "scale", "strength", "ac_peak", "noise_floor"):
        parts.append(check(key, _rel_excess(got[key], ref[key], TOL["peak_atol"],
                                            TOL["peak_rtol"]), 1.0))
    if not all(bool(torch.isfinite(v).all()) for v in got.values()):
        failures.append(f"detect_lean[{label}]: non-finite outputs")
    print(f"[3 check] detect_lean[{label}] max_abs={e:.3e} " + " ".join(parts),
          flush=True)
    return e


def _service_phase(torch, cfg, dev, streams, card, check, failures):
    """Phase 6: the streaming receive service through StreamingReceiver.

    Returns the detection kernels' launch counts from their main-path runs
    and their (kernel, plain) times at the service's shapes."""
    from gfdm_tpu_torch.kernels import detect
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
              + f"step {ms:.3f} ms = {samples / (ms / 1e3):.4e} samples/s "
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

    # detection kernels vs their plain versions at the service's shapes
    s = torch.from_numpy(streams["friendly"][0]).to(dev)
    times = {}
    for key, kern, plain in (
        ("detect_front", detect._detect_front_cuda, detect._detect_front_plain),
        ("detect_lean", detect._detect_lean_cuda, detect._detect_lean_plain),
    ):
        p1 = _time_ms(torch, lambda: plain(cfg, s, CHUNK_LEN))
        k1 = _time_ms(torch, lambda: kern(cfg, s, CHUNK_LEN))
        k2 = _time_ms(torch, lambda: kern(cfg, s, CHUNK_LEN))
        p2 = _time_ms(torch, lambda: plain(cfg, s, CHUNK_LEN))
        times[key] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"[6 time] {key}: kernel {k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms,"
              f" kernel {N_CHUNKS * s.shape[-1] / (times[key][0] / 1e3):.4e} samples/s "
              f"(B={N_CHUNKS}, T={s.shape[-1]}, {card})", flush=True)
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
    their max errors against the plain versions, the dense receiver and
    link kernels' errors at K = 128, and (kernel, plain) times at the
    full-width points."""
    import ctypes

    from gfdm_tpu_torch.entry import large_k_config, planar_payload
    from gfdm_tpu_torch.kernels import cuda_lib, fused
    from gfdm_tpu_torch.ops.planar_pipeline import evm, link_step_planar

    batch = {K_ESTIMATOR: B_LARGE_K, **dict(LARGE_K)}
    cfgs = {K: large_k_config(K) for K in batch}
    payload = {K: torch.from_numpy(planar_payload(cfgs[K], batch[K], seed=K)).to(dev)
               for K in batch}
    err = {"tx_factored": 0.0, "rx_factored": 0.0, "rx_factored_chan": 0.0,
           "rx": 0.0, "link": 0.0}

    # 7a. each factored kernel against its plain version on the same inputs
    for K, estimator in ((K_FULL, "fast"), (K_ESTIMATOR, "fused")):
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
        err[key] = max(ec, es)
        print(f"[7 check] K={K} B={batch[K]} " + " ".join([
            check("tx_factored", e_tx, TOL["tx"]),
            check(f"{key}:chan", ec, TOL["chan"]),
            check(f"{key}:symbols", es, TOL["symbols"]),
        ]), flush=True)
        del bursts, noisy, chan, sym, rchan, rsym

    # 7a. the dense receiver and link kernels at K = 128, where they take a
    # tile of fewer bursts than the canonical 8
    cfg, data = cfgs[K_ESTIMATOR], payload[K_ESTIMATOR]
    B128 = batch[K_ESTIMATOR]
    tile = cuda_lib.library().gfdm_rx_tile_bursts(ctypes.byref(fused._dims(cfg, B128)))
    noisy = _noisy(torch, fused.tx_frame_fused(cfg, data), 3).reshape(B128, -1)
    chan, sym, _met = fused.rx_receiver_fused(cfg, noisy.reshape(B128, 2, -1))
    rchan, rsym, _rmet = fused._rx_receiver_plain(cfg, noisy, 2, "conv")
    d_hat, _snr, _evm = fused.link_single_fused(cfg, data)
    ref, _met = fused._link_single_plain(cfg, data.reshape(B128, -1), 2, "conv")
    ec = _max_abs(chan.reshape(B128, -1), rchan)
    es = _max_abs(sym.reshape(B128, -1), rsym)
    err["rx"], err["link"] = max(ec, es), _max_abs(d_hat.reshape(B128, -1), ref)
    print(f"[7 check] dense kernels at K={K_ESTIMATOR} B={B128}: tile={tile} bursts "
          + " ".join([check("tile!=4", float(tile != 4), 0.0),
                      check("rx:chan", ec, TOL["chan"]),
                      check("rx:symbols", es, TOL["symbols"]),
                      check("link:data", err["link"], TOL["data"])]), flush=True)
    del noisy, chan, sym, rchan, rsym, d_hat, ref

    # 7b. the large-K link through the user's entry points, launches counted
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    links = {(K, est): fused.link_step_factored(cfgs[K], payload[K], estimator=est)
             for K, est in ((K_FULL, "fast"), (K_ESTIMATOR, "fused"))}
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    run = _launches()
    launches = {key: run[key] for key in ("tx_factored", "rx_factored", "rx_factored_chan")}
    for key, v in launches.items():
        if v < 1:
            failures.append(f"kernel {key} was not launched on the large-K path")
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
    print(f"[7 main] launches={launches} host {host_s * 1e3:.1f} ms", flush=True)
    del links

    # 7c. times: kernel vs plain (plain, kernel, kernel, plain) and the link
    # through the kernels, their plain versions and the torch-op fast chain
    times = {}

    def timed(fn_k, fn_p):
        p1, k1, k2, p2 = (_time_ms(torch, f) for f in (fn_p, fn_k, fn_k, fn_p))
        return (k1 + k2) / 2, (p1 + p2) / 2, f"{k1:.3f}/{k2:.3f}", f"{p1:.3f}/{p2:.3f}"

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
            k_ms, p_ms, ks, ps = timed(fn_k, fn_p)
            if K in (K_FULL, K_ESTIMATOR) and name != "link":
                times[name] = (k_ms, p_ms)
            print(f"[7 time] K={K} B={Bk} {name}: kernel {ks} ms, plain {ps} ms "
                  f"({card})", flush=True)
            if name == "link":
                chain = _time_ms(torch, lambda: link_step_planar(cfg, data, method="fast"))
                est = _time_ms(torch, lambda: fused._fast_channel(cfg, bursts))
                sps = Bk * cfg.frame_len
                print(f"[7 time] K={K} B={Bk} link samples/s: kernels "
                      f"{sps / (k_ms / 1e3):.4e}, plain {sps / (p_ms / 1e3):.4e}, "
                      f"torch-op fast chain {sps / (chain / 1e3):.4e} ({chain:.3f} ms); "
                      f"torch-op estimate {est:.3f} ms ({card})", flush=True)
        del bursts
    return launches, err, times


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
    small = data[: min(B, 4099)]
    for si in range(len(cfg_s.cyclic_shifts)):
        got = fused.tx_frame_fused(cfg_s, small, shift_index=si)
        ref = fused._tx_frame_plain(cfg_s, small.reshape(small.shape[0], -1), si)
        e = _max_abs(got.reshape(ref.shape), ref)
        err["tx"] = max(err["tx"], e)
        parts.append(check(f"tx[B={small.shape[0]},shift={cfg_s.cyclic_shifts[si]}]",
                           e, TOL["tx"]))
    bursts = fused.tx_frame_fused(cfg, data)
    e = _max_abs(bursts.reshape(B, -1), fused._tx_frame_plain(cfg, flat, 0))
    err["tx"] = max(err["tx"], e)
    parts.append(check(f"tx[B={B},shift=0]", e, TOL["tx"]))
    print("[3 check] " + " ".join(parts), flush=True)

    noisy = _noisy(torch, bursts, 1)
    noisy_flat = noisy.reshape(B, -1)
    for mode in ("conv", "matmul"):
        chan, sym, met = fused.rx_receiver_fused(cfg, noisy, ic_mode=mode)
        rchan, rsym, rmet = fused._rx_receiver_plain(cfg, noisy_flat, 2, mode)
        n_cnr = fused._met_layout(cfg)[0]
        ec, es = _max_abs(chan.reshape(B, -1), rchan), _max_abs(sym.reshape(B, -1), rsym)
        err["rx"] = max(err["rx"], ec, es)
        print(f"[3 check] rx[{mode}] " + " ".join([
            check("chan", ec, TOL["chan"]),
            check("symbols", es, TOL["symbols"]),
            check("snr_rel", _max_rel(met[:, 0], rmet[:, 0]), TOL["snr_rtol"]),
            check("cnr_rel", _max_rel(met[:, 1 : 1 + n_cnr], rmet[:, 1 : 1 + n_cnr]),
                  TOL["cnr_rtol"]),
            check("pad", float(met[:, 1 + n_cnr :].abs().max()), 0.0),
        ]), flush=True)
        del chan, sym, met, rchan, rsym, rmet
    for mode in ("conv", "matmul"):
        d_hat, _snr, _evm = fused.link_single_fused(cfg, data, ic_mode=mode)
        ref, _met = fused._link_single_plain(cfg, flat, 2, mode)
        e = _max_abs(d_hat.reshape(B, -1), ref)
        err["link"] = max(err["link"], e)
        print(f"[3 check] link[{mode}] " + check("data", e, TOL["data"]), flush=True)
        del d_hat, ref

    # 3. detection kernels vs plain on the service's friendly chunks
    streams = {
        name: service_stream(cfg, N_CHUNKS, CHUNK_LEN, 20.0, impaired,
                             np.random.default_rng(0))
        for name, impaired in (("friendly", False), ("impaired", True))
    }
    friendly_dev = torch.from_numpy(streams["friendly"][0]).to(dev)
    ragged = friendly_dev[:N_RAGGED, :, : friendly_dev.shape[-1] - RAGGED_TRIM]
    ragged = ragged.contiguous()
    err["detect_front"] = err["detect_lean"] = 0.0
    for label, s_in in ((f"B={N_CHUNKS},T={friendly_dev.shape[-1]}", friendly_dev),
                        (f"B={N_RAGGED},T={ragged.shape[-1]}", ragged)):
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
    }
    times = {}
    for name, (kern, plain) in runs.items():
        p1 = _time_ms(torch, plain)
        k1 = _time_ms(torch, kern)
        k2 = _time_ms(torch, kern)
        p2 = _time_ms(torch, plain)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        rate = B * cfg.frame_len / (times[name][0] / 1e3)
        print(f"[5 time] {name}: kernel {k1:.3f}/{k2:.3f} ms, plain "
              f"{p1:.3f}/{p2:.3f} ms, kernel {rate:.4e} samples/s "
              f"(B={B}, {card})", flush=True)

    # 6. the streaming receive service
    svc_launches, det_times = _service_phase(torch, cfg, dev, streams, card,
                                             check, failures)
    launches.update(svc_launches)
    times.update(det_times)

    # 7. the large-K factored path
    lk_launches, lk_err, lk_times = _large_k_phase(torch, dev, card, check, failures)
    launches.update(lk_launches)
    times.update(lk_times)
    for key, e in lk_err.items():
        err[key] = max(err.get(key, 0.0), e)

    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    kernels = []
    for key, (name, source, replaces) in SOURCES.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": err[key], "ms": times[key][0],
            "plain_ms": times[key][1],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
