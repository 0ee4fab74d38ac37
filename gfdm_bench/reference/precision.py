"""The precisions a reference stage may be computed in.

A precision names how the operands of a stage are rounded before the stage
runs and in which dtype it then runs:

- ``float64``: no rounding, complex128 arithmetic (the reference);
- ``tf32``: float32 operands rounded to TF32's 10-bit mantissa (round to
  nearest even), float32 arithmetic: what a tensor core in TF32 mode does
  to a float32 product;
- ``bfloat16``: operands rounded to bfloat16, float32 arithmetic;
- ``fp8``: operands scaled by their row's largest magnitude onto the
  float8 e4m3 range, rounded to it and scaled back, float32 arithmetic.

``rounder(p)`` returns the rounding of a real or complex tensor;
``compute_dtype(p)`` the complex dtype the stage runs in.
"""
from __future__ import annotations

import torch

PRECISIONS = ("float64", "tf32", "bfloat16", "fp8")
_FP8_MAX = 448.0


def compute_dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return torch.complex128 if precision == "float64" else torch.complex64


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.to(torch.float32).view(torch.int32).to(torch.int64)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    scale = amax / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _real_rounder(precision: str):
    if precision == "float64":
        return lambda x: x.to(torch.float64)
    if precision == "tf32":
        return _tf32
    if precision == "bfloat16":
        return lambda x: x.to(torch.bfloat16).to(torch.float32)
    if precision == "fp8":
        return _fp8
    raise ValueError(f"unknown precision {precision!r}")


def rounder(precision: str):
    """x -> x rounded to ``precision`` (real or complex; complex tensors
    come back in :func:`compute_dtype`, real ones in float64 or float32)."""
    real = _real_rounder(precision)
    cdt = compute_dtype(precision)

    def fn(x: torch.Tensor) -> torch.Tensor:
        if x.is_complex():
            parts = torch.view_as_real(x.to(torch.complex128))
            # fp8 scales each plane by its row's largest magnitude
            r = real(parts.movedim(-1, 0)).movedim(0, -1)
            return torch.view_as_complex(r.to(torch.float64).contiguous()).to(cdt)
        return real(x)

    return fn
