"""Plumbing shared by the complex-dtype ops (``ops/tx.py``, ``rx.py``,
``estimation.py``, ``sync.py``, ``burst.py``): inputs become complex tensors
on a device, operators become device constants built once, and products run
in full float32 (no TF32) on a card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor, device_const

__all__ = ["DEFAULT_DTYPE", "np_dtype", "real_dtype", "as_complex", "const", "mm"]

DEFAULT_DTYPE = torch.complex64
_NP = {torch.complex64: np.complex64, torch.complex128: np.complex128}


def np_dtype(dtype: torch.dtype):
    """The NumPy dtype of a torch complex dtype (complex64 or complex128)."""
    try:
        return _NP[dtype]
    except KeyError:
        raise ValueError(f"expected torch.complex64 or torch.complex128, got {dtype}") from None


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.complex128 else torch.float32


def as_complex(x, dtype: torch.dtype, device, who: str) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor: a tensor stays on its device unless
    ``device`` names another; a NumPy array goes to ``device``, the card by
    default (raising without one)."""
    np_dtype(dtype)
    return as_tensor(x, device, who).to(dtype)


def const(key, cfg, dtype: torch.dtype, device, build) -> torch.Tensor:
    """``build()`` (a NumPy array built in float64 / complex128) cast once
    to ``dtype``'s NumPy type, as the JAX package casts its operators, and
    held on ``device``."""
    return device_const((key, cfg, str(dtype)), device,
                        lambda: np.asarray(build()).astype(np_dtype(dtype)))


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w; on a card with TF32 off for the call (cuBLAS's complex GEMMs
    would otherwise take TF32 when a caller has turned it on)."""
    if x.device.type != "cuda":
        return x @ w
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return x @ w
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
