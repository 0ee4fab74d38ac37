"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit) and the least time of a piece of work.

The flop peak is the fastest rate at which any implementation that passes
the benchmark's float32 comparisons can retire float32-accurate products:
TF32 tensor cores at 495 TFLOP/s, three TF32 products (3xTF32) a
float32-accurate one, so 165 TFLOP/s (above the 67 TFLOP/s of float32 on
the CUDA cores and of FP64 tensor cores). A single TF32 or bf16 product
fails the comparisons (the controls), so their peaks do not bound a correct
implementation. Bytes against HBM3's 3.35 TB/s.
"""
from __future__ import annotations

H100_SXM = {
    "tf32_tensor_flops": 495e12,
    "fp32_accurate_flops": 495e12 / 3,
    "fp32_cuda_core_flops": 67e12,
    "hbm_bytes_per_s": 3.35e12,
    "power_limit_w": 700.0,
}


def least_seconds(work: dict, peaks: dict = H100_SXM) -> tuple[float, str]:
    """(least seconds, which bound sets it: "flops" or "bytes")."""
    t_ops = work["flops"] / peaks["fp32_accurate_flops"]
    t_mem = work["bytes"] / peaks["hbm_bytes_per_s"]
    return (t_ops, "flops") if t_ops >= t_mem else (t_mem, "bytes")
