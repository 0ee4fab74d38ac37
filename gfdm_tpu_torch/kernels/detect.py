"""Fused detection front end: the whole sync trace chain in one CUDA kernel.

The port of ``gfdm_tpu.kernels.detect`` (the Pallas kernels ``_kernel`` and
``_kernel2``). One CUDA template in ``gfdm_tpu_torch/csrc/detect.cu``
computes, per position of each chunk, the K-lag autocorrelation, the 2K
energy, the normalized autocorrelation, its backward CP integration (zeros
before the chunk start) and the preamble cross-correlation gated by it. Its
two instantiations differ in what they write:

- ``detect_front_fused`` (kernel A, ``_kernel``): the five traces, with the
  contract of ``ops.planar_pipeline._detect_front_planar``;
- ``detect_bursts_fused`` (kernel B, ``_kernel2``): only the gated metric
  and the CP-integrated trace; the argmax, the peak values, the noise-floor
  median and CFO/scale from the 2K-sample window at the peak are torch ops.

Beside each kernel is its plain torch version (``_detect_front_plain``,
``_detect_lean_plain``), written the direct way: sliding sums and the
correlation as float32 convolutions. A wrapper runs the plain version only
for a tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import GfdmConfig
from ..ops.planar_pipeline import _FLOOR_STRIDE, _conv_xcorr, _median, _take

__all__ = ["LAUNCHES", "detect_front_fused", "detect_bursts_fused"]

# kernel launches per wrapper since the last reset (plain runs do not count)
LAUNCHES = {"detect_front": 0, "detect_lean": 0}

_CONSTS: dict = {}
_TAP_PAD = 64  # a multiple of 2 x DETECT_R (8 in csrc/detect.cu)


def _taps_np(cfg: GfdmConfig) -> np.ndarray:
    """(2, 2K) float32 [re; im] of the normalized conjugate core preamble:
    the column of the JAX kernels' banded xcorr operator."""
    p = np.conjugate(cfg.core_preamble)
    p = p / np.sqrt(np.mean(np.abs(p) ** 2))
    return np.stack([p.real.astype(np.float32), p.imag.astype(np.float32)])


def _kernel_taps_np(cfg: GfdmConfig) -> np.ndarray:
    """(KP, 2) float32 interleaved [re, im] taps, zero past 2K, KP = 2K
    rounded up to _TAP_PAD: the kernels' FIR reads them a float4 (two taps)
    at a time, up to 2K rounded up to 2 x csrc/detect.cu DETECT_R."""
    taps = _taps_np(cfg)
    w = taps.shape[1]
    out = np.zeros((-(-w // _TAP_PAD) * _TAP_PAD, 2), np.float32)
    out[:w] = taps.T
    return out


def _consts(cfg: GfdmConfig, device) -> dict:
    """The kernels' constants on ``device``, built once per (config, device):
    the xcorr taps (2, 2K), the same interleaved as the kernels read them,
    and for the plain versions the same taps as 2-channel conv weights."""
    device = torch.device(device)
    key = (cfg, str(device))
    hit = _CONSTS.get(key)
    if hit is None:
        taps = torch.from_numpy(_taps_np(cfg)).to(device)
        tr, ti = taps[0], taps[1]
        conv = torch.stack([torch.stack([tr, -ti]), torch.stack([ti, tr])])
        hit = _CONSTS[key] = {"taps": taps, "conv": conv.contiguous(),
                              "taps_k": torch.from_numpy(_kernel_taps_np(cfg)).to(device)}
    return hit


# ---------------------------------------------------------------------------
# plain torch versions (what the kernels compute)
# ---------------------------------------------------------------------------
def _window_sum(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, L) -> (B, L - w + 1): out[t] = sum(x[t : t + w]), summed directly."""
    ones = torch.ones((1, 1, w), dtype=x.dtype, device=x.device)
    return _conv_xcorr(x[:, None, :], ones)[:, 0, :]


def _traces_plain(cfg: GfdmConfig, flat: torch.Tensor, lean: bool):
    """(B, 2, T) chunks -> (cc magnitude / 2K, ac planes, energy, |ac|)."""
    K, cp = cfg.subcarriers, cfg.cp_len
    T = flat.shape[-1]
    n_ac = T - 2 * K
    sr, si = flat[:, 0], flat[:, 1]
    ar, ai, br, bi = sr[:, : T - K], si[:, : T - K], sr[:, K:], si[:, K:]
    pr = _window_sum(ar * br + ai * bi, K)[:, :n_ac]
    pi = _window_sum(ar * bi - ai * br, K)[:, :n_ac]
    e = torch.clamp(_window_sum(sr * sr + si * si, 2 * K)[:, :n_ac], min=1e-30)
    g = 2.0 / e
    acr, aci = pr * g, pi * g
    if lean:
        mag = torch.sqrt(pr * pr + pi * pi) * g
    else:
        mag = torch.sqrt(acr * acr + aci * aci)
    ic = _window_sum(torch.nn.functional.pad(mag, (cp, 0)), cp + 1) / (cp + 1)
    cc = _conv_xcorr(flat, _consts(cfg, flat.device)["conv"])[..., :n_ac]
    ccm = torch.sqrt((cc[:, 0] ** 2 + cc[:, 1] ** 2) / float((2 * K) ** 2))
    return ccm, torch.stack([acr, aci], dim=1), e, ic


def _detect_front_plain(cfg: GfdmConfig, flat: torch.Tensor, n_valid: int):
    """(B, 2, T) -> gated (B, n_valid), ac (B, 2, n_ac), energy, ic (B, n_ac)."""
    ccm, ac, e, ic = _traces_plain(cfg, flat, lean=False)
    return ccm[:, :n_valid] * ic[:, :n_valid], ac, e, ic


def _detect_lean_plain(cfg: GfdmConfig, flat: torch.Tensor, n_valid: int):
    """(B, 2, T) -> gated (B, n_valid), ic (B, n_valid)."""
    ccm, _ac, _e, ic = _traces_plain(cfg, flat, lean=True)
    return ccm[:, :n_valid] * ic[:, :n_valid], ic[:, :n_valid]


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------
def _run(name: str, cfg: GfdmConfig, flat: torch.Tensor, n_valid: int, *outs):
    """Launch ``gfdm_<name>`` on ``flat``; raise if the launch is refused."""
    from .cuda_lib import DetectDims, launch

    B, _, T = flat.shape
    dims = DetectDims(batch=B, length=T, subcarriers=cfg.subcarriers,
                      cp_len=cfg.cp_len, n_ac=T - 2 * cfg.subcarriers,
                      n_valid=n_valid)

    def tile(lib):
        return (f"; the {name} tile keeps {lib.gfdm_detect_smem_bytes(ctypes.byref(dims))}"
                f" B in shared memory a CTA (K={cfg.subcarriers}, cp_len={cfg.cp_len})")

    taps = _consts(cfg, flat.device)["taps_k"]
    ptrs = [None if o is None else o.data_ptr() for o in outs]
    launch(f"gfdm_{name}", (ctypes.byref(dims), flat.data_ptr(), taps.data_ptr(), *ptrs),
           flat.device, hint=tile)
    LAUNCHES[name] += 1


def _detect_front_cuda(cfg: GfdmConfig, flat: torch.Tensor, n_valid: int):
    B, _, T = flat.shape
    n_ac = T - 2 * cfg.subcarriers
    opts = dict(dtype=torch.float32, device=flat.device)
    gated = torch.empty(B, n_valid, **opts)
    ac = torch.empty(B, 2, n_ac, **opts)
    energy, ic = torch.empty(B, n_ac, **opts), torch.empty(B, n_ac, **opts)
    _run("detect_front", cfg, flat, n_valid, gated, ac, energy, ic)
    return gated, ac, energy, ic


def _detect_lean_cuda(cfg: GfdmConfig, flat: torch.Tensor, n_valid: int):
    B = flat.shape[0]
    opts = dict(dtype=torch.float32, device=flat.device)
    gated, ic = torch.empty(B, n_valid, **opts), torch.empty(B, n_valid, **opts)
    _run("detect_lean", cfg, flat, n_valid, gated, None, None, ic)
    return gated, ic


# ---------------------------------------------------------------------------
# public wrappers
# ---------------------------------------------------------------------------
def _flat_chunks(cfg: GfdmConfig, s: torch.Tensor, search_limit: int, fn: str):
    """Validate (..., 2, T) float32 chunks -> (contiguous (B, 2, T), n_ac,
    n_valid, on CUDA)."""
    if not isinstance(s, torch.Tensor):
        raise TypeError(f"{fn}: expected a torch.Tensor, got {type(s).__name__}")
    if s.ndim < 2 or s.shape[-2] != 2:
        raise ValueError(f"{fn}: expected planar (..., 2, T) chunks, got {tuple(s.shape)}")
    if s.dtype != torch.float32:
        raise TypeError(f"{fn}: expected float32, got {s.dtype}")
    if s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {s.device}")
    T = s.shape[-1]
    n_ac = T - 2 * cfg.subcarriers
    if n_ac < 1:
        raise ValueError(f"{fn}: chunks of {T} samples hold no 2K = "
                         f"{2 * cfg.subcarriers} window")
    n_valid = min(n_ac, int(search_limit))
    if n_valid < 1:
        raise ValueError(f"{fn}: search_limit must be >= 1, got {search_limit}")
    flat = s.reshape(-1, 2, T).contiguous()
    return flat, n_ac, n_valid, s.device.type == "cuda"


def detect_front_fused(cfg: GfdmConfig, s: torch.Tensor, search_limit: int):
    """Fused front end: (..., 2, T) planar chunks -> (gated (..., n_valid),
    ac (..., 2, n_ac), energy (..., n_ac), ic (..., n_ac)) with n_ac = T - 2K
    and n_valid = min(n_ac, search_limit): the contract of
    ops.planar_pipeline._detect_front_planar."""
    flat, n_ac, n_valid, cuda = _flat_chunks(cfg, s, search_limit, "detect_front_fused")
    run = _detect_front_cuda if cuda else _detect_front_plain
    gated, ac, energy, ic = run(cfg, flat, n_valid)
    lead = tuple(s.shape[:-2])
    return (gated.reshape(lead + (n_valid,)), ac.reshape(lead + (2, n_ac)),
            energy.reshape(lead + (n_ac,)), ic.reshape(lead + (n_ac,)))


def detect_bursts_fused(cfg: GfdmConfig, s: torch.Tensor, search_limit: int,
                        floor_stride: int = _FLOOR_STRIDE):
    """Trace-lean fused detection: (..., 2, T) -> detection dict.

    The contract of ops.planar_pipeline.detect_bursts_planar without the
    ac_metric trace: start/cfo/scale/strength/ac_peak/noise_floor. Only the
    gated metric and the CP-integrated trace leave the kernel; CFO and scale
    come from the 2K-sample window at the detected peak.
    """
    flat, _n_ac, n_valid, cuda = _flat_chunks(cfg, s, search_limit, "detect_bursts_fused")
    run = _detect_lean_cuda if cuda else _detect_lean_plain
    det = _lean_epilogue(cfg, flat, *run(cfg, flat, n_valid), floor_stride)
    lead = tuple(s.shape[:-2])
    return {key: v.reshape(lead) for key, v in det.items()}


def _lean_epilogue(cfg: GfdmConfig, flat: torch.Tensor, gated: torch.Tensor,
                   ic: torch.Tensor, floor_stride: int = _FLOOR_STRIDE) -> dict:
    """(B, 2, T) chunks and their (B, n_valid) gated / ic traces -> the
    per-chunk detection dict (torch ops)."""
    K = cfg.subcarriers
    nc = torch.argmax(gated, dim=-1, keepdim=True)
    strength = _take(gated, nc)[:, 0]
    ac_peak = _take(ic, nc)[:, 0]
    floor = _median(ic[:, ::floor_stride])

    # peak-local window: samples [nc, nc + 2K) give both the K-lag
    # autocorrelation (CFO angle) and the 2K energy (scale)
    idx = nc + torch.arange(2 * K, device=flat.device)
    win = torch.gather(flat, -1, idx[:, None, :].expand(-1, 2, -1))
    wr, wi = win[:, 0, :], win[:, 1, :]
    a_re, a_im, b_re, b_im = wr[:, :K], wi[:, :K], wr[:, K:], wi[:, K:]
    p_r = torch.sum(a_re * b_re + a_im * b_im, dim=-1)
    p_i = torch.sum(a_re * b_im - a_im * b_re, dim=-1)
    cfo = torch.atan2(p_i, p_r) / (2.0 * np.pi)
    energy = torch.clamp(torch.sum(wr * wr + wi * wi, dim=-1), min=1e-30)
    scale = torch.sqrt((2.0 * K) / energy)
    return {"start": nc[:, 0], "cfo": cfo, "scale": scale, "strength": strength,
            "ac_peak": ac_peak, "noise_floor": floor}
