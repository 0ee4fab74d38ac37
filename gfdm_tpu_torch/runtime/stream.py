"""Continuous-stream processing: chunked burst reception on one device.

The port of the planar part of ``gfdm_tpu.runtime.stream``. A long IQ
recording is split into fixed chunks with a one-frame lookahead halo so
every burst is fully contained in exactly one extended chunk, then the
batched detector/receiver runs over all chunks at once (cf. the reference's
partial-burst deferral, extract_burst_cc_impl.cc:214-228). Both forms:
``receive_long_stream`` on complex tensors (the ops of ``ops/sync.py``,
``ops/burst.py`` and ``runtime/receiver.py``) and the planar
``receive_chunks_planar`` / ``receive_long_stream_planar`` the service runs.
"""
from __future__ import annotations

import torch

from ..config import GfdmConfig

__all__ = [
    "chunk_with_lookahead",
    "receive_long_stream",
    "receive_chunks_planar",
    "receive_long_stream_planar",
]


def chunk_with_lookahead(stream: torch.Tensor, chunk_len: int, halo: int):
    """(..., T) -> (..., n_chunks, chunk_len + halo) with lookahead overlap.

    The tail chunk's halo is zero-padded (end of recording).
    """
    n_chunks = stream.shape[-1] // chunk_len
    padded = torch.nn.functional.pad(stream[..., : n_chunks * chunk_len], (0, halo))
    return padded.unfold(-1, chunk_len + halo, chunk_len).contiguous()


def _found_mask(det: dict, chunk_len: int, min_strength, false_alarm_prob):
    """Ownership AND detection decision for per-slot outputs.

    Default rule: the constant-false-alarm-rate threshold derived from
    ``false_alarm_prob`` (ops.sync.detection_valid). ``min_strength`` (a raw
    gated-peak floor) overrides it when set.
    """
    from ..ops import sync as sync_ops

    owned = det["start"] < chunk_len
    if min_strength is not None:
        return owned & (det["strength"] > min_strength)
    return owned & sync_ops.detection_valid(det, false_alarm_prob)


def _flatten_slots(det_k: dict, keys=("start", "cfo", "scale", "strength", "ac_peak")):
    """(..., k)-slotted detection dict -> flat per-slot dict (+ noise floor)."""
    det = {key: det_k[key].reshape(-1) for key in keys}
    det["noise_floor"] = det_k["noise_floor"][..., None].expand(
        det_k["start"].shape
    ).reshape(-1)
    return det


def receive_long_stream(
    cfg: GfdmConfig,
    stream,
    chunk_len: int = 2048,
    ic_iterations: int = 2,
    min_strength: float | None = None,
    correct_cfo: bool = True,
    max_bursts_per_chunk: int = 1,
    false_alarm_prob: float = 1e-5,
    device=None,
):
    """Receive every burst in a long complex recording (..., T).

    Returns the per-slot receiver outputs plus a ``found`` mask. With
    ``max_bursts_per_chunk > 1`` each chunk contributes that many detection
    slots (iterative peak suppression, strongest first) so densely packed
    bursts - up to one per frame length - are all recovered. Detection
    decision: see :func:`_found_mask`. A NumPy recording goes to ``device``:
    the card unless the caller passes ``device="cpu"``.
    """
    from ..ops import burst as burst_ops
    from ..ops import sync as sync_ops
    from ..ops._complex import DEFAULT_DTYPE, as_complex
    from .receiver import receive_bursts

    halo = cfg.frame_len + cfg.cp_len
    stream = as_complex(stream, DEFAULT_DTYPE, device, "receive_long_stream")
    chunks = chunk_with_lookahead(stream, chunk_len, halo)
    if max_bursts_per_chunk <= 1:
        det = sync_ops.detect_bursts(cfg, chunks, search_limit=chunk_len)
        det = {k: v for k, v in det.items() if k != "ac_metric"}
        bursts = burst_ops.extract_bursts(cfg, chunks, det, correct_cfo=correct_cfo)
    else:
        k = int(max_bursts_per_chunk)
        det_k = sync_ops.detect_bursts_topk(cfg, chunks, max_bursts=k,
                                            search_limit=chunk_len)
        # flatten (n_chunks, k) slots -> one burst batch
        rep = chunks[..., None, :].expand(chunks.shape[:-1] + (k, chunks.shape[-1]))
        det = _flatten_slots(det_k)
        bursts = burst_ops.extract_bursts(cfg, rep.reshape((-1, chunks.shape[-1])), det,
                                          correct_cfo=correct_cfo)
    out = receive_bursts(cfg, bursts, ic_iterations=ic_iterations)
    out["detection"] = det
    out["found"] = _found_mask(det, chunk_len, min_strength, false_alarm_prob)
    return out


def receive_chunks_planar(
    cfg: GfdmConfig,
    chunks: torch.Tensor,
    chunk_len: int,
    ic_iterations: int = 2,
    min_strength: float | None = None,
    correct_cfo: bool = True,
    max_bursts_per_chunk: int = 1,
    dtype_name: str = "float32",
    method: str = "dense",
    equalizer: str = "zf",
    false_alarm_prob: float = 1e-5,
    constellation: str = "qpsk",
    detect_dtype_name: str | None = None,
    refine_cfo: bool = True,
):
    """Receive every burst in a batch of extended chunks (torch ops).

    ``chunks``: (..., 2, chunk_len + halo) planar, halo-extended (as from
    :func:`chunk_with_lookahead` or a native StreamBuffer). Detection is
    restricted to owned positions (< chunk_len); the found mask is
    :func:`_found_mask`. ``detect_dtype_name`` sets the detection and
    extraction dtype independently of the receiver's (defaults to
    ``dtype_name``). ``refine_cfo`` re-estimates the residual CFO from the
    payload block's CP after the coarse correction at extraction.

    The receiver runs with the dense operators or, with ``method="fast"``,
    the factorized stages of ops.planar_fast, in float32 or, with
    ``dtype_name="bfloat16"``, with bf16 operators.
    """
    from ..ops import planar_pipeline as pp
    from ..ops.rx import constellation_points

    dd = detect_dtype_name or dtype_name
    C = chunks.shape[-1]
    if max_bursts_per_chunk <= 1:
        det = pp.detect_bursts_planar(cfg, chunks, search_limit=chunk_len, dtype_name=dd)
        det = {k: v for k, v in det.items() if k != "ac_metric"}
        bursts = pp.extract_bursts_planar(cfg, chunks, det, correct_cfo=correct_cfo,
                                          dtype_name=dd)
    else:
        k = int(max_bursts_per_chunk)
        det_k = pp.detect_bursts_topk_planar(cfg, chunks, max_bursts=k,
                                             search_limit=chunk_len, dtype_name=dd)
        rep = chunks[..., None, :, :].expand(chunks.shape[:-2] + (k, 2, C))
        det = _flatten_slots(det_k)
        bursts = pp.extract_bursts_planar(cfg, rep.reshape((-1, 2, C)), det,
                                          correct_cfo=correct_cfo, dtype_name=dd)
    if refine_cfo and correct_cfo:
        bursts, _ = pp.refine_cfo_planar(cfg, bursts)
    out = pp.receive_bursts_planar(
        cfg, bursts, ic_iterations=ic_iterations, equalizer=equalizer,
        constellation=constellation_points(constellation), method=method,
        dtype_name=dtype_name,
    )
    out["detection"] = det
    out["found"] = _found_mask(det, chunk_len, min_strength, false_alarm_prob)
    return out


def receive_long_stream_planar(
    cfg: GfdmConfig,
    stream: torch.Tensor,
    chunk_len: int = 2048,
    ic_iterations: int = 2,
    min_strength: float | None = None,
    correct_cfo: bool = True,
    max_bursts_per_chunk: int = 1,
    dtype_name: str = "float32",
    method: str = "dense",
    equalizer: str = "zf",
    false_alarm_prob: float = 1e-5,
    constellation: str = "qpsk",
):
    """Receive every burst of a (..., 2, T) planar IQ recording.

    Returns the per-slot receiver outputs plus detection metadata and a
    ``found`` mask, with slots flattened over (chunks, bursts-per-chunk).
    """
    halo = cfg.frame_len + cfg.cp_len
    chunks = chunk_with_lookahead(stream, chunk_len, halo)
    # (..., 2, n_chunks, C) -> (..., n_chunks, 2, C)
    chunks = torch.movedim(chunks, -2, -3).contiguous()
    return receive_chunks_planar(
        cfg, chunks, chunk_len,
        ic_iterations=ic_iterations,
        min_strength=min_strength,
        correct_cfo=correct_cfo,
        max_bursts_per_chunk=max_bursts_per_chunk,
        dtype_name=dtype_name,
        method=method,
        equalizer=equalizer,
        false_alarm_prob=false_alarm_prob,
        constellation=constellation,
    )
