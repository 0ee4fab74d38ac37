"""Argument validation with actionable errors (the port of
``gfdm_tpu.ops._validate``; the counterpart of the reference kernels'
std::invalid_argument constructor checks)."""
from __future__ import annotations

__all__ = ["check_last_dim", "check_planar"]


def check_last_dim(x, expected: int, what: str, of: str):
    if x.shape[-1] != expected:
        raise ValueError(
            f"{what}: last dimension must be {of} = {expected}, "
            f"got shape {tuple(x.shape)}"
        )


def check_planar(x, expected: int, what: str, of: str):
    if x.ndim < 2 or x.shape[-2] != 2:
        raise ValueError(
            f"{what}: expected planar layout (..., 2, n) with re/im planes, "
            f"got shape {tuple(x.shape)}"
        )
    if x.shape[-1] != expected:
        raise ValueError(
            f"{what}: last dimension must be {of} = {expected}, "
            f"got shape {tuple(x.shape)}"
        )
