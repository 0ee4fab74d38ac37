#!/usr/bin/env python3
"""Run the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # canonical config, B = 65,536 bursts

Phases, one line each (any failure exits non-zero and prints no result):

1. device  - requires CUDA; prints the card's name and power limit.
2. build   - compiles the CUDA kernels of gfdm_tpu_torch/csrc with nvcc.
3. check   - each kernel against its plain torch version on the same CUDA
             inputs: the Tx at a ragged batch and shifts (0, 4), the
             receiver on noisy bursts (AWGN 20 dB) and the one-kernel link,
             both IC modes.
4. main    - the entry step (link_single_fused, matmul IC) and
             link_step_fused (Tx kernel -> receiver kernel) at full batch,
             with the launch counters reset just before; EVM against the
             plain versions and the planar torch-op link.
5. time    - each kernel and its plain version, CUDA events after warm-up.

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
}
SOURCES = {
    "tx": ("tx_frame_fused", "gfdm_tpu_torch/csrc/tx.cu",
           "gfdm_tpu/kernels/fused.py:1662"),
    "rx": ("rx_receiver_fused", "gfdm_tpu_torch/csrc/rx.cu",
           "gfdm_tpu/kernels/fused.py:343"),
    "link": ("link_single_fused", "gfdm_tpu_torch/csrc/link.cu",
             "gfdm_tpu/kernels/fused.py:1403"),
}


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from gfdm_tpu_torch import GfdmConfig
    from gfdm_tpu_torch.entry import entry, planar_payload
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

    rng = np.random.default_rng(1)
    sig_pow = float((bursts**2).sum(dim=1).mean())  # mean |x|^2 per sample
    sigma = (sig_pow / 10 ** (20 / 10) / 2) ** 0.5
    noise = rng.standard_normal((B, 2, cfg.frame_len), dtype=np.float32)
    noisy = bursts + sigma * torch.from_numpy(noise).to(dev)
    del noise
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

    # 4. the main path at full batch, through the user's entry points
    step, (example,) = entry(dev)
    _d, _s, evm_example = step(example)
    for k in fused.LAUNCHES:
        fused.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_hat, snr, evm_link = step(data)
    d_split, snr_split, evm_split = fused.link_step_fused(cfg, data)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = dict(fused.LAUNCHES)
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
