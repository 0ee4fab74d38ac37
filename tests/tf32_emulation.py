"""Plain emulation of the link kernels' 3xTF32 products (csrc/link_gemm.cuh),
for tests/test_torch_link_tc.py (the CPU) and tests/test_torch_gpu.py (the
card's split against it). Imports torch only."""
import torch

from gfdm_tpu_torch.kernels import fused


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 as the kernels' cvt.rna (nearest, ties away from
    zero): the float32 bits plus 0x1000, the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo) = (tf32(x), tf32(x - hi)): the 3xTF32 operand split."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels' 3xTF32 product: lo*hi + hi*lo + hi*hi. The
    tensor cores form each TF32 x TF32 product exactly (22 significant bits)
    and sum in float32, as these float32 matmuls of the parts do."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return al @ bh + ah @ bl + ah @ bh


def gdot_3xtf32(xr, xi, g, n_in):
    """fused._gdot with each float32-stack product as 3xTF32 (bf16 stacks as
    _gdot)."""
    if g.dtype == torch.bfloat16:
        return fused._gdot(xr, xi, g, n_in)
    p1 = mm_3xtf32(xr, g[:n_in])
    p2 = mm_3xtf32(xi, g[n_in : 2 * n_in])
    p3 = mm_3xtf32(xr + xi, g[2 * n_in :])
    return p1 - p2, p3 - p1 - p2
