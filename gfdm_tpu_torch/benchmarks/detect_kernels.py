"""The detection kernels alone on the card, at the service's shapes.

Times, with CUDA events around ``reps`` calls after two warm-up calls, both
instantiations of ``csrc/detect.cu`` (PERF.md rows 12-13: ``detect_front``,
the five traces behind ``detect_front_fused``; ``detect_lean``, gated and
ic behind ``detect_bursts_fused``) on the friendly service stream
(``entry.service_stream`` seed 0: 4,096 chunks, T = 2,816, n_valid =
2,048). One line a kernel: ms, the traces' largest excess over the limits
chip_smoke.py holds them to against the plain version (<= 1 passes), and
ptxas's registers and spills; then the card's name and power limit
(chip_smoke.py states the kernels' bounds). A variant of ``detect.cu`` is
timed by running this script from a patched copy of the repo.

    python -m gfdm_tpu_torch.benchmarks.detect_kernels [--reps 20]

It needs a CUDA device and nvcc, and exits 1 without a device.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import service_stream
from gfdm_tpu_torch.kernels import cuda_lib, detect

N_CHUNKS, CHUNK_LEN = 4096, 2048
TRACE_TOL = (3e-5, 3e-3)  # chip_smoke.py's trace_atol, trace_rtol


def time_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls after two warm-ups."""
    fn()
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _ptxas(log: str) -> dict:
    """{"detect_front" / "detect_lean": "<registers>; <spills>"} from an nvcc log."""
    out, key = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"detect_kernelILb([01])E", ln)
            key = None if m is None else ("detect_lean" if m.group(1) == "1" else "detect_front")
        elif key and ("registers" in ln or "spill" in ln):
            out[key] = (out.get(key, "") + "; " + ln.split(":", 1)[-1].strip()).lstrip("; ")
    return out


def excess(got, ref) -> float:
    atol, rtol = TRACE_TOL
    return max(float(((g - r).abs() - rtol * r.abs()).max()) / atol for g, r in zip(got, ref))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("detect_kernels: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = GfdmConfig()
    s = torch.from_numpy(service_stream(cfg, N_CHUNKS, CHUNK_LEN, 20.0, False,
                                        np.random.default_rng(0))[0]).to(dev)
    plain = {"detect_front": detect._detect_front_plain(cfg, s, CHUNK_LEN),
             "detect_lean": detect._detect_lean_plain(cfg, s, CHUNK_LEN)}
    runs = {"detect_front": lambda: detect._detect_front_cuda(cfg, s, CHUNK_LEN),
            "detect_lean": lambda: detect._detect_lean_cuda(cfg, s, CHUNK_LEN)}
    cuda_lib.library()
    info = cuda_lib.build_info()
    regs = _ptxas(info["log"] or Path(info["path"]).with_suffix(".log").read_text())
    for key, run in runs.items():
        err = excess(run(), plain[key])
        ms = time_ms(run, args.reps)
        print(f"{key}: {ms:.4f} ms, trace excess {err:.3f} (B={N_CHUNKS}, T={s.shape[-1]}); "
              f"ptxas {regs.get(key, '?')}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
