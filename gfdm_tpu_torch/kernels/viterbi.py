"""Viterbi decoder: the ACS recursion and its traceback in one CUDA kernel.

``coding.viterbi_decode`` hands every mode's trellis to :func:`decode`: a
batch of codewords of T steps, decoded k steps a collapsed step (radix
2^k), with two per-codeword options, the initial metrics (state 0 pinned,
or a given 64-vector) and where the traceback starts (state 0, the
zero-terminated end, or the first argmax of the final metrics). The
windowed mode is that on its windows, folded into the batch.

One CUDA template in ``gfdm_tpu_torch/csrc/viterbi.cu`` runs the whole
decode, one warp a codeword, with the pattern sums, metrics and decisions
in shared memory; where a block's decisions outgrow it (T past ~3,200 for
every radix) the same kernel keeps them in a global scratch that the
wrapper allocates, so the card decodes any T the CPU does. It replaces no Pallas kernel (the JAX package decodes
with ``lax.scan``). Its plain version, ``_decode_plain``, is the torch-op
decoder of ``coding`` (``_pattern_sums``, ``_forward``, ``_traceback``),
whose arithmetic the kernel repeats: the bits are identical on any float32
input. A tensor on the CPU runs the plain version; a CUDA tensor launches
the kernel or raises. ``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .. import coding
from ..device import device_const
from ..utils.profiling import span

__all__ = ["LAUNCHES", "decode", "kernel_tables"]

# kernel launches since the last reset (plain runs do not count)
LAUNCHES = {"viterbi": 0}


@lru_cache(maxsize=4)
def kernel_tables(k: int) -> dict:
    """The trellis as the kernel reads it, for radix 2^k (k in 1..4):

    - ``pred`` (64, 2^k): predecessor j of next state ns,
      ``(ns >> k) | (j << (6 - k))``, which the kernel computes;
    - ``q_j`` (2^k,) and ``q_ns`` (64,) int32: the pattern index of the
      transition (ns, j) is ``q_j[j] ^ q_ns[ns]``, its 2k coded bits read
      oldest first (a bit set where the code emits 1, i.e. where the term
      is negated in ``coding._pattern_sums``). The code is linear, so the
      bits of the (6 + k)-bit input sequence (j's bits, then ns's) split
      into a part of j and a part of ns.

    Derived from ``coding.conv_encode`` alone: the encoder run over the
    sequence, its outputs for the last k inputs."""
    if not 1 <= k <= 4:
        raise ValueError(f"radix 2^k takes k in 1..4, got {k}")
    nb = coding.CONV_TAIL_BITS + k

    def index(seq: int) -> int:
        bits = (seq >> np.arange(nb - 1, -1, -1)) & 1  # oldest input first
        out = coding.conv_encode(bits)[2 * coding.CONV_TAIL_BITS : 2 * nb]
        return int((out.astype(np.int64) << np.arange(2 * k - 1, -1, -1)).sum())

    ns, j = np.arange(64)[:, None], np.arange(1 << k)[None, :]
    return {
        "pred": ((ns >> k) | (j << (coding.CONV_TAIL_BITS - k))).astype(np.int64),
        "q_j": np.array([index(jj << coding.CONV_TAIL_BITS) for jj in range(1 << k)],
                        np.int32),
        "q_ns": np.array([index(s) for s in range(64)], np.int32),
    }


def _check(lp: torch.Tensor, k: int, pm0, from_argmax) -> None:
    """Raise ValueError on what the kernel does not take."""
    if not isinstance(lp, torch.Tensor):
        raise ValueError(f"viterbi: expected a torch.Tensor, got {type(lp).__name__}")
    if lp.dtype != torch.float32:
        raise ValueError(f"viterbi: expected float32 LLRs, got {lp.dtype}")
    if lp.ndim != 3 or lp.shape[-1] != 2 or lp.shape[1] < 1:
        raise ValueError(f"viterbi: expected (B, T, 2) LLRs, got {tuple(lp.shape)}")
    if not lp.is_contiguous():
        raise ValueError("viterbi: the LLRs must be contiguous")
    if k not in (1, 2, 3, 4) or lp.shape[1] % k:
        raise ValueError(f"viterbi: radix 2^{k} on T = {lp.shape[1]} (k in 1..4 dividing T)")
    if lp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"viterbi: unsupported device {lp.device}")
    B = lp.shape[0]
    for name, t, shape, dtype in (("pm0", pm0, (B, coding._NSTATES), torch.float32),
                                  ("from_argmax", from_argmax, (B,), torch.bool)):
        if t is None:
            continue
        if (not isinstance(t, torch.Tensor) or tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous() or t.device != lp.device):
            raise ValueError(f"viterbi: {name} must be a contiguous {dtype} tensor of shape "
                             f"{shape} on {lp.device}")


# ---------------------------------------------------------------------------
# plain torch version (what the kernel computes)
# ---------------------------------------------------------------------------
def _decode_plain(lp: torch.Tensor, k: int, pm0=None, from_argmax=None) -> torch.Tensor:
    """(B, T, 2) LLRs -> (B, T) bits: the torch-op ACS over T / k steps,
    then the traceback from state 0 or, where ``from_argmax``, from the
    first argmax of the final metrics."""
    B, T = lp.shape[:2]
    lt = lp.reshape(B, T // k, 2 * k).transpose(0, 1)
    idx = device_const(("pattern", k), lp.device, lambda: coding._pattern_index(k))
    if pm0 is None:
        pm0 = coding._initial_metrics(B, lp.device)
    with span("gfdm.fec.viterbi"):
        with span("gfdm.fec.acs"):
            pm, decs = coding._forward(coding._pattern_sums(lt), idx, k, pm0)
        with span("gfdm.fec.traceback"):
            if from_argmax is None:
                state = torch.zeros(B, dtype=torch.int64, device=lp.device)
            else:
                state = torch.where(from_argmax, pm.argmax(dim=-1), 0)
            return coding._traceback(decs, state, k)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------
@lru_cache(maxsize=4)
def _kernel_struct(k: int):
    """kernel_tables(k) as the kernel's ``ViterbiTables`` argument."""
    from .cuda_lib import ViterbiTables

    tabs = kernel_tables(k)
    tab = ViterbiTables()
    tab.q_j[: 1 << k] = tabs["q_j"].tolist()
    tab.q_ns[:] = tabs["q_ns"].tolist()
    return tab


@lru_cache(maxsize=16)
def _scratch_bytes(T: int, k: int, device: torch.device) -> int:
    """Global scratch bytes a codeword needs on ``device`` (0 where the
    decisions of a block fit in its shared memory)."""
    from .cuda_lib import launch

    out = ctypes.c_size_t()
    launch("gfdm_viterbi_scratch_bytes", (T, k, ctypes.byref(out)), device)
    return out.value


def _decode_cuda(lp: torch.Tensor, k: int, pm0=None, from_argmax=None) -> torch.Tensor:
    from .cuda_lib import launch

    B, T = lp.shape[:2]
    if lp.data_ptr() % 16:  # a view into its storage: the kernel reads 16-byte vectors
        lp = lp.clone()
    tab = _kernel_struct(k)
    bits = torch.empty((B, T), dtype=torch.uint8, device=lp.device)
    nbytes = _scratch_bytes(T, k, lp.device)
    scratch = torch.empty(B * nbytes, dtype=torch.uint8, device=lp.device) if nbytes else None
    with span("gfdm.fec.viterbi"):
        launch("gfdm_viterbi", (ctypes.byref(tab), B, T, k, lp.data_ptr(),
                                None if pm0 is None else pm0.data_ptr(),
                                None if from_argmax is None else from_argmax.data_ptr(),
                                None if scratch is None else scratch.data_ptr(),
                                bits.data_ptr()), lp.device)
    LAUNCHES["viterbi"] += 1
    return bits


# ---------------------------------------------------------------------------
# public wrapper
# ---------------------------------------------------------------------------
def decode(lp: torch.Tensor, k: int, pm0=None, from_argmax=None) -> torch.Tensor:
    """Decode (B, T, 2) float32 LLRs (contiguous; positive favours bit 0)
    k trellis steps a step -> (B, T) uint8 bits, each step's k bits oldest
    first. ``pm0``: (B, 64) float32 initial metrics, or None for state 0
    pinned (every other state at -1e30). ``from_argmax``: (B,) bool, where
    True the traceback starts at the first argmax of the final metrics,
    else (or for None) at state 0. Raises ValueError on other inputs."""
    _check(lp, k, pm0, from_argmax)
    run = _decode_cuda if lp.device.type == "cuda" else _decode_plain
    return run(lp, k, pm0, from_argmax)
