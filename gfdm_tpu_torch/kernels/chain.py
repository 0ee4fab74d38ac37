"""The link's GEMM chain: ``x @ W1 @ W2 @ W3`` in CUDA at f32, bf16 and int8.

The port of the Pallas kernel of ``benchmarks/int8_gauss.py`` (``build``,
with the bodies ``_chain_f32``, ``_chain_bf16`` and ``_chain_int8``): the
one-kernel link's three chained realified products at its chain shapes,
(B, 936) -> 1152 -> 1152 -> 1152 (:data:`CHAIN_SHAPES`), the experiment
that asks what tensor cores give on this card, in time and in accuracy.

- ``f32``: float32 products and sums.
- ``bf16``: the activation rounded to bf16 before each product, bf16
  weights, float32 sums and output.
- ``int8``: before each product the activation of each 128-row group is
  quantized with that group's absmax (``s = 127 / max(m, 1e-20)``,
  ``clip(round(x s), -127, 127)``, round half to even); int8 weights
  quantized on the host (:func:`quantize_weights`, the script's own numpy
  code) with a float32 inverse scale ``inv`` each; int32 sums; the stage
  output is ``float(acc) * (c * max(m, 1e-20))`` with ``c = inv / 127``
  rounded to float32. That is how XLA evaluates the script's
  ``acc * (inv / s)``: it folds ``inv / (127 / m')`` into
  ``(inv / 127) * m'``, one ulp off the IEEE quotient for about one scale in
  three (pinned against the JAX package in tests/test_torch_chain.py). The
  128-row group is part of the function.

:func:`gemm_chain` runs ``csrc/chain.cu`` for a tensor on the card (one
launch a stage for f32; for bf16 a pass rounding x to bf16, then one a
stage on TMA and ``wgmma``; for int8 a pass quantizing x into an int8
plane, then one s8 TMA + ``wgmma`` launch a stage, stages 1 and 2 as
thread-block clusters that settle each group's scale and store the next
stage's int8 operand: :data:`INT8_LAUNCHES`) and the plain torch version
(:func:`_chain_plain`) for a tensor on the CPU. The JAX kernel's grid
leaves a remainder of rows unwritten; here a batch that is not a multiple
of 128 raises. ``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import contextlib
import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.planar import bf16_operator

__all__ = ["CHAIN_SHAPES", "GROUP", "VARIANTS", "LAUNCHES", "INT8_LAUNCHES", "ChainWeights",
           "quantize_weights", "chain_weights_from_numpy", "gemm_chain"]

# the one-kernel link's chain (K = 64: 2 n_data = 936 in, 2 N = 1152 a stage)
CHAIN_SHAPES = ((936, 1152), (1152, 1152), (1152, 1152))
GROUP = 128  # rows sharing one int8 activation scale (the Pallas block)
VARIANTS = ("f32", "bf16", "int8")
# kernel launches per wrapper since the last reset (plain runs do not count)
LAUNCHES = {"chain_f32": 0, "chain_bf16": 0, "chain_int8": 0}
_KERNELS = {"f32": 3, "bf16": 4, "int8": 4}  # launches of one call
# the int8 call's launches, in order (csrc/chain.cu int8_launch)
INT8_LAUNCHES = ("quantize_x", "stage1", "stage2", "stage3")
_VARIANT_IDS = {"f32": 0, "bf16": 1, "int8": 2}  # csrc/chain.cu's variant
_KPAD = 64  # the CUDA bf16 and int8 operands' k padding (csrc/chain.cu KPAD)
_HID = 1152  # the CUDA kernels' stage width (csrc/chain.cu HID)


def quantize_weights(weights) -> tuple[list[np.ndarray], list[np.float32]]:
    """Per-tensor absmax int8 weights and float32 inverse scales, the numpy
    code of ``benchmarks/int8_gauss.py:78-84`` verbatim."""
    wqs, invs = [], []
    for w in weights:
        sw = 127.0 / np.abs(w).max()
        wqs.append(np.clip(np.round(w * sw), -127, 127).astype(np.int8))
        invs.append(np.float32(1.0 / sw))
    return wqs, invs


@dataclass(frozen=True)
class ChainWeights:
    """The chain's weights in one mode.

    ``w``: three (d_in, d_out) tensors, float32, bf16 or int8. ``inv``
    (int8): the float32 inverse weight scales. ``w_t`` (bf16, int8): the
    CUDA kernels' operands, each weight transposed to (d_out, k) with k
    zero-padded to a multiple of 64.
    """

    variant: str
    w: tuple
    inv: tuple = ()
    w_t: tuple = ()

    @property
    def device(self) -> torch.device:
        return self.w[0].device

    def to(self, device) -> "ChainWeights":
        move = lambda ts: tuple(t.to(device) for t in ts)  # noqa: E731
        return ChainWeights(self.variant, move(self.w), self.inv, move(self.w_t))


def _transposed_operand(w: torch.Tensor) -> torch.Tensor:
    """(d_in, d_out) -> the CUDA kernels' K-major operand: (d_out, k), k =
    d_in rounded up to a multiple of 64, zero-padded (128-byte bf16 rows)."""
    d_in, d_out = w.shape
    wt = w.new_zeros(d_out, -(-d_in // _KPAD) * _KPAD)
    wt[:, :d_in] = w.T
    return wt


def chain_weights_from_numpy(weights, variant: str) -> ChainWeights:
    """The chain's weights as the JAX script makes them (numpy, any float
    dtype) -> the port's, as ``build`` casts them: float32; bf16 rounded
    once by torch from the numpy values (ml_dtypes' rounding); int8 by
    :func:`quantize_weights`."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r} (use one of {', '.join(VARIANTS)})")
    weights = [np.asarray(w) for w in weights]
    if len(weights) != 3 or any(w.ndim != 2 for w in weights):
        raise ValueError("expected three 2-D weights")
    for a, b in zip(weights, weights[1:]):
        if a.shape[1] != b.shape[0]:
            raise ValueError(f"chain shapes do not connect: {a.shape} then {b.shape}")
    if variant == "f32":
        return ChainWeights(variant, tuple(torch.from_numpy(w.astype(np.float32)) for w in weights))
    if variant == "bf16":
        ws = tuple(bf16_operator(w) for w in weights)
        return ChainWeights(variant, ws, w_t=tuple(_transposed_operand(w) for w in ws))
    wqs, invs = quantize_weights(weights)
    return ChainWeights(variant, tuple(torch.from_numpy(w) for w in wqs),
                        tuple(float(v) for v in invs),
                        tuple(_transposed_operand(torch.from_numpy(w)) for w in wqs))


# ---------------------------------------------------------------------------
# plain torch versions, stage by stage (what the kernels compute)
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _no_tf32(device: torch.device):
    """float32 matmuls in full float32 on a card (torch's default, stated)."""
    if device.type != "cuda":
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _dequant_const(inv: float) -> float:
    """c = inv / 127 in float32: the constant XLA folds out of inv / s."""
    return float(np.float32(inv) / np.float32(127.0))


def _quantize_groups(a: torch.Tensor):
    """(B, d) float32 -> the int8 values as float64 (G, 128, d) and each
    group's max(m, 1e-20) (G, 1, 1) float32. The divide is tensor by tensor:
    torch's scalar / tensor takes a reciprocal and would round twice."""
    g = a.reshape(a.shape[0] // GROUP, GROUP, a.shape[1])
    m = torch.clamp(g.abs().amax(dim=(1, 2), keepdim=True), min=1e-20)
    s = torch.full_like(m, 127.0) / m
    q = torch.clamp(torch.round(g * s), -127.0, 127.0)
    return q.double(), m


def _int8_stage(a: torch.Tensor, wq: torch.Tensor, inv: float) -> torch.Tensor:
    """One int8 stage. The products of the int8 values are float64 matmuls:
    exact, as every sum is at most 1152 * 127^2 < 2^53, so any order gives
    the int32 accumulator's value; torch has no integer matmul on a card."""
    q, m = _quantize_groups(a)
    acc = torch.matmul(q, wq.double())
    return (acc.float() * (m * _dequant_const(inv))).reshape(a.shape[0], -1)


def _chain_plain(x: torch.Tensor, cw: ChainWeights) -> torch.Tensor:
    a = x
    if cw.variant == "int8":
        for wq, inv in zip(cw.w, cw.inv):
            a = _int8_stage(a, wq, inv)
        return a
    with _no_tf32(x.device):
        for w in cw.w:
            if cw.variant == "bf16":
                a = torch.matmul(a.to(torch.bfloat16).float(), w.float())
            else:
                a = torch.matmul(a, w)
    return a


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------
def _chain_scratch(batch: int, variant: str, device):
    """The kernels' scratch for one call: (intermediates, int8 group maxima
    or None). f32: two float32 (B, 1152) planes, one a stage's output;
    bf16: one (B, 1152) bf16 plane (bf16(x), then stage 2's output; stage 1
    writes into the bytes of ``out``); int8: two int8 (B, 1152) planes
    (x's int8 copy, its rows d_in rounded up to a multiple of 64 bytes apart,
    then stage 2's output; stage 1's output) and the (3, B / 128) group
    maxima, each stage's input's."""
    if variant == "bf16":
        return torch.empty(batch, _HID, dtype=torch.bfloat16, device=device), None
    if variant != "int8":
        return torch.empty(2, batch, _HID, dtype=torch.float32, device=device), None
    return (torch.empty(2, batch, _HID, dtype=torch.int8, device=device),
            torch.empty(3, batch // GROUP, dtype=torch.int32, device=device))


def _chain_cuda(x: torch.Tensor, cw: ChainWeights, events=None) -> torch.Tensor:
    """The chain on the card. ``events`` (int8): a list that takes a CUDA
    event before each launch and after the last (the launches then go one
    C call each, :data:`INT8_LAUNCHES`)."""
    from .cuda_lib import launch
    from .fused import _record

    B, d_in = x.shape
    if d_in % 8 or d_in > _HID or any(w.shape[1] != _HID for w in cw.w):
        raise ValueError(f"the chain kernels take d_in <= {_HID} (a multiple of 8) and "
                         f"{_HID}-wide stages, got {[tuple(w.shape) for w in cw.w]}")
    if events is not None and cw.variant != "int8":
        raise ValueError("per-launch events are taken for int8 only")
    out = torch.empty(B, _HID, dtype=torch.float32, device=x.device)
    scratch, gmax = _chain_scratch(B, cw.variant, x.device)
    ws = cw.w_t if cw.w_t else cw.w
    consts = tuple(_dequant_const(v) for v in cw.inv) if cw.inv else (0.0, 0.0, 0.0)
    variant, n = _VARIANT_IDS[cw.variant], _KERNELS[cw.variant]
    args = (B, d_in, x.data_ptr(), *(w.data_ptr() for w in ws),
            *(ctypes.c_float(v) for v in consts), out.data_ptr(), scratch.data_ptr(),
            None if gmax is None else gmax.data_ptr())
    for part in ([-1] if events is None else range(n)):
        _record(events)
        launch("gfdm_chain", (variant, part, *args), x.device)
    _record(events)
    LAUNCHES[f"chain_{cw.variant}"] += n
    return out


def int8_clusters(device) -> dict:
    """The int8 stage's clusters on ``device`` (a card): how many the card
    holds at once (``cudaOccupancyMaxActiveClusters``), CTAs a cluster, and
    dynamic shared memory a CTA in bytes."""
    from .cuda_lib import library

    lib = library()
    got = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        rc = lib.gfdm_chain_int8_clusters(got)
    if rc != 0:
        raise RuntimeError(f"gfdm_chain_int8_clusters: {lib.gfdm_error_string(rc).decode()} "
                           f"({rc}): no cluster of the int8 stage fits the card")
    return {"active_clusters": got[0], "cluster": got[1], "smem_bytes": got[2]}


def gemm_chain(x: torch.Tensor, weights: ChainWeights, variant: str | None = None):
    """``x @ W1 @ W2 @ W3`` in the mode of ``weights`` (from
    :func:`chain_weights_from_numpy`; ``variant``, if given, must be it).

    x: (B, d_in) float32 with B a multiple of 128 -> (B, d_out) float32. On
    the card it launches csrc/chain.cu (the real shapes only: d_in <= 1152,
    1152-wide stages) or raises; on the CPU it runs the plain version.
    """
    if variant is not None and variant != weights.variant:
        raise ValueError(f"weights are {weights.variant!r}, not {variant!r}")
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"gemm_chain: expected a torch.Tensor, got {type(x).__name__}")
    if x.ndim != 2 or x.shape[1] != weights.w[0].shape[0]:
        raise ValueError(f"gemm_chain: expected (B, {weights.w[0].shape[0]}), "
                         f"got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"gemm_chain: expected float32, got {x.dtype}")
    if x.shape[0] % GROUP:
        raise ValueError(f"gemm_chain: batch {x.shape[0]} is not a multiple of {GROUP}")
    if x.device.type not in ("cpu", "cuda") or weights.device != x.device:
        raise ValueError(f"gemm_chain: x on {x.device}, weights on {weights.device}")
    x = x.contiguous()
    return _chain_cuda(x, weights) if x.device.type == "cuda" else _chain_plain(x, weights)
