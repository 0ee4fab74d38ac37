"""Constants carried across from the JAX package.

``operators_from_numpy`` turns the JAX package's host constants - its
operator matrices, small constants, selection matrices and bf16 IC stack,
as NumPy arrays - into the port's constant cache: the names, dtypes and
index forms that ``ops.planar_pipeline._device_mats`` and
``kernels.fused._kernel_consts`` build. The tests use it to show that both
packages compute with the same operators, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .kernels.fused import _QPSK_AMP
from .ops.planar_pipeline import _to_tensor

__all__ = ["operators_from_numpy"]


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":  # ml_dtypes: same bits as torch.bfloat16
        a = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(a).view(torch.bfloat16).to(device)
    return _to_tensor(a, device)


def _columns_of(sel: np.ndarray) -> np.ndarray:
    """Row index of the single 1 in each column of a 0/1 selection matrix."""
    if not (np.isin(sel, (0, 1)).all() and (sel.sum(axis=0) == 1).all()):
        raise ValueError("expected exactly one 1 in every column")
    return np.argmax(sel, axis=0).astype(np.int32)


def _put(out: dict, name: str, t: torch.Tensor) -> None:
    hit = out.get(name)
    if hit is not None and not (hit.dtype == t.dtype and torch.equal(hit, t)):
        raise ValueError(f"{name}: inputs disagree")
    out[name] = t


def operators_from_numpy(np_consts: dict, device="cpu") -> dict[str, torch.Tensor]:
    """JAX-package constants (NumPy) -> the port's constant cache on ``device``.

    Arrays pass through under their names (integers as int32, ml_dtypes
    bf16 as torch.bfloat16). These names are translated:

    - ``met_selection`` (2K, met_w) -> ``sig_idx`` and ``noise_idx``;
    - ``demap_selection`` (N, n_data) -> ``demap_idx``;
    - ``ic_matmul_stack`` (3N, N) bf16 -> ``icop``;
    - ``C_W`` -> also ``taps`` (2, M), column 0 of the circulant times the
      QPSK amplitude (the conv-mode IC taps);
    - ``active`` (K,) -> also ``act`` (N,), the per-symbol mask (needs
      ``ic_taps`` beside it, as ``_small_consts`` gives both);
    - ``circ_masks`` (M-1, N) is checked against ``(col % M) < j`` and
      dropped: the port's kernels compute that rotation by index.
    """
    out: dict[str, torch.Tensor] = {}
    for name, a in np_consts.items():
        a = np.asarray(a)
        if name == "met_selection":
            n_cnr = int(a[:, 0].sum())
            _put(out, "sig_idx", _tensor(_columns_of(a[:, 2 : 2 + n_cnr]), device))
            _put(out, "noise_idx", _tensor(np.nonzero(a[:, 1])[0], device))
        elif name == "demap_selection":
            _put(out, "demap_idx", _tensor(_columns_of(a), device))
        elif name == "ic_matmul_stack":
            _put(out, "icop", _tensor(a, device))
        elif name == "circ_masks":
            M = a.shape[0] + 1
            cols = np.arange(a.shape[1]) % M
            want = np.stack([(cols < j) for j in range(1, M)]).astype(a.dtype)
            if not np.array_equal(a, want):
                raise ValueError("circ_masks is not the (col % M) < j pattern")
        else:
            _put(out, name, _tensor(a, device))
            if name == "C_W":  # realified (2M, 2M): row 0 is [c.real | c.imag]
                M = a.shape[0] // 2
                c = np.stack([a[0, :M], a[0, M:]]).astype(np.float32)
                taps = (c.astype(np.float64) * _QPSK_AMP).astype(np.float32)
                _put(out, "taps", _tensor(taps, device))
            elif name == "active":  # with its _small_consts sibling ic_taps (2, M)
                M = np.asarray(np_consts["ic_taps"]).shape[-1]
                _put(out, "act", _tensor(np.repeat(a.astype(np.float32), M), device))
    return out
