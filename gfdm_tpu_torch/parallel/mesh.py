"""Device-mesh parallelism for burst streams, on torch devices.

The port of ``gfdm_tpu.parallel.mesh``. Frames are embarrassingly parallel
(gr-gfdm/lib/transmitter_cc_impl.cc:165-177), so the mesh has two axes:

  - 'dp': bursts or chunks split over the mesh's rows (the throughput
    axis); no communication in steady state.
  - 'sp': a long IQ stream's sample axis split into chunks over a row's
    columns. The only cross-chunk coupling is a burst straddling a
    boundary, a fixed-width halo: each shard takes the head of its right
    neighbour's chunk (``halo_exchange_right``; the JAX package's ppermute).
  - metrics sum over shards, and over processes with
    ``torch.distributed.all_reduce`` (``psum_metrics``).

A mesh is a (dp, sp) grid of ``torch.device``; a device may repeat. A
"virtual" mesh of one device repeated (the CPU eight times in the tests,
one card n times) runs the same grouping code that several cards would:
shards that share a device run as one batched call, so on one card every
kernel runs at the full width of the batch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import GfdmConfig
from ..device import move
from ..device import resolve_device

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_bursts",
    "dp_map",
    "halo_exchange_right",
    "detect_bursts_sharded",
    "psum_metrics",
]


class Mesh:
    """A (dp, sp) grid of torch devices with ``shape = {"dp": dp, "sp": sp}``
    (the keys of ``jax.sharding.Mesh.shape``); ``devices[r, j]`` is the
    device of row r, column j."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = {"dp": devices.shape[0], "sp": devices.shape[1]}

    def distinct_devices(self) -> list:
        """Each device of the mesh once, in row-major order."""
        return list(dict.fromkeys(self.devices.flat))

    def __repr__(self) -> str:
        return f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, devices={self.distinct_devices()})"


def make_mesh(devices=None, dp: int | None = None, sp: int = 1) -> Mesh:
    """Mesh over ``devices`` with ('dp', 'sp') axes.

    ``devices=None`` takes every visible CUDA device (without one it raises,
    naming ``device='cpu'``). A device may repeat: ``["cpu"] * 8`` or
    ``["cuda:0"] * n`` is a virtual mesh.
    """
    if devices is None:
        resolve_device(None, "make_mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp}*{sp} != {n} devices")
    grid = np.empty((dp, sp), dtype=object)
    for i, d in enumerate(devs):
        grid[i // sp, i % sp] = d
    return Mesh(grid)


def device_runs(devices) -> list[tuple[torch.device, int, int]]:
    """Consecutive positions that share a device: [(device, first, stop)]."""
    runs = []
    for i, d in enumerate(devices):
        if runs and runs[-1][0] == d:
            runs[-1] = (d, runs[-1][1], i + 1)
        else:
            runs.append((d, i, i + 1))
    return runs


def _row_size(mesh: Mesh, batch: int, who: str) -> int:
    dp = mesh.shape["dp"]
    if batch % dp:
        raise ValueError(f"{who}: batch {batch} does not split into dp={dp} rows")
    return batch // dp


def shard_bursts(mesh: Mesh, array, batch_axis: int = 0) -> list[torch.Tensor]:
    """Split ``array``'s batch axis into dp pieces, piece r on row r's
    (first) device."""
    x = torch.as_tensor(array)
    b = _row_size(mesh, x.shape[batch_axis], "shard_bursts")
    return [move(piece, mesh.devices[r, 0])
            for r, piece in enumerate(torch.split(x, b, dim=batch_axis))]


def _cat_outputs(outs: list, device):
    """Per-run results (a tensor, or a dict / tuple of them) -> one, each
    tensor concatenated along its batch axis on ``device``."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([move(t, device) for t in outs])
    if isinstance(first, dict):
        return {k: _cat_outputs([o[k] for o in outs], device) for k in first}
    return type(first)(_cat_outputs([o[i] for o in outs], device) for i in range(len(first)))


def dp_map(mesh: Mesh, fn, x):
    """``fn`` over a batch sharded on 'dp' (the counterpart of a jitted
    function of a dp-sharded array): ``x`` is split into dp rows, rows that
    share a device run as one call of ``fn`` on that device, and the results
    (a tensor, or a dict / tuple of tensors, batch first) come back in batch
    order on ``x``'s device."""
    x = torch.as_tensor(x)
    b = _row_size(mesh, x.shape[0], "dp_map")
    outs = [fn(move(x[r0 * b : r1 * b], dev))
            for dev, r0, r1 in device_runs(mesh.devices[:, 0])]
    return outs[0] if len(outs) == 1 else _cat_outputs(outs, x.device)


def _extend_runs(runs: list, width: int, halo: int) -> list[torch.Tensor]:
    """``runs``: the shards of each run of one ring laid end to end on the
    run's device, (..., n_run * width) each. Returns (..., n_run, width +
    halo) windows a run: each shard followed by its right neighbour's first
    ``halo`` samples. A run's last shard takes the head of the next run,
    copied to the run's device; the ring's last shard takes the first
    shard's head (the wrap)."""
    out = []
    for i, x in enumerate(runs):
        right = runs[(i + 1) % len(runs)][..., :halo]
        ext = torch.cat([x, move(right, x.device)], dim=-1)
        out.append(ext.unfold(-1, width + halo, width))
    return out


def halo_exchange_right(shards: list, halo: int) -> list[torch.Tensor]:
    """Append the first ``halo`` samples of the right neighbour's shard.

    ``shards``: one ring of sample-axis shards, (..., T_local) each on its
    device, in ring order. Shard i gets the head of shard (i + 1) mod n; the
    last shard receives the first shard's head, and its detections there
    are discarded by the ownership mask. Consecutive shards on one device
    take one ``torch.cat`` + ``unfold``; a head crossing to another device
    takes one non-blocking copy.

    (..., T_local) each -> (..., T_local + halo) each
    """
    width = shards[0].shape[-1]
    if not 0 < halo <= width:
        raise ValueError(f"halo {halo} must be in (0, {width}], the shard width")
    runs = [torch.cat(shards[a:b], dim=-1) if b - a > 1 else shards[a]
            for _d, a, b in device_runs([s.device for s in shards])]
    return [w for win in _extend_runs(runs, width, halo) for w in win.unbind(-2)]


# detection dict keys of detect_bursts_sharded, and those ranked per slot
_DET_KEYS = ("start", "cfo", "scale", "strength", "ac_peak", "noise_floor", "owned", "found")
_VAL_KEYS = ("start", "cfo", "scale", "strength", "ac_peak")


def _rank_slots(det_all: dict, chunk_len: int, k: int, false_alarm_prob: float) -> dict:
    """The k kept slots of each window's k + 1 picks: CFAR-valid owned picks
    first, then CFAR-valid ones, then raw strength (strengths are O(1)).
    The score is summed in float64 and sorted stably, as jnp.argsort sorts,
    so tied scores (an empty shard) keep the pick order."""
    from ..ops import sync as sync_ops

    owned_all = det_all["start"] < chunk_len
    valid_all = sync_ops.detection_valid(det_all, false_alarm_prob)
    score = (det_all["strength"].double() + 1e6 * (valid_all & owned_all).double()
             + 1e3 * valid_all.double())
    order = torch.argsort(-score, dim=-1, stable=True)[..., :k]
    det = {key: torch.gather(det_all[key], -1, order) for key in _VAL_KEYS}
    det["noise_floor"] = det_all["noise_floor"][..., None].expand(det["start"].shape)
    det["owned"] = det["start"] < chunk_len
    det["found"] = det["owned"] & torch.gather(valid_all, -1, order)
    return det


def detect_bursts_sharded(
    cfg: GfdmConfig,
    mesh: Mesh,
    stream,
    halo: int | None = None,
    planar: bool = False,
    false_alarm_prob: float = 1e-5,
    max_bursts_per_chunk: int = 1,
):
    """Burst detection over a stream whose sample axis is sharded on 'sp'.

    ``stream``: (batch, n_sp * chunk_len) complex - or, with ``planar=True``,
    (batch, 2, n_sp * chunk_len) real planes - with batch split over 'dp'
    and the sample axis over 'sp'. Each shard extends its chunk with a
    ``halo`` from the right neighbour (``halo_exchange_right``) and searches
    the whole extended window, so a burst near a chunk boundary is
    typically seen twice: by its owner (start < chunk_len) and by the left
    neighbour inside its halo (start >= chunk_len). The ``owned`` mask
    keeps exactly one (gr-gfdm/lib/extract_burst_cc_impl.cc:214-228's
    partial-burst deferral).

    Per shard, ``max_bursts_per_chunk + 1`` picks are taken (the extra one
    absorbs a neighbour's boundary burst in the halo) and ranked: CFAR-valid
    owned picks, then CFAR-valid picks, then raw strength.

    Returns (detection dict incl. ``owned``/``found``, extracted bursts) in
    the layout (batch, n_sp, ...) when ``max_bursts_per_chunk == 1``, else
    (batch, n_sp, k, ...), on the stream's device. The shards of each
    device run as one batched detection and extraction call.
    """
    from ..ops import burst as burst_ops
    from ..ops import planar_pipeline as pp
    from ..ops import sync as sync_ops

    if halo is None:
        halo = cfg.padded_frame_len
    k = int(max_bursts_per_chunk)
    if k < 1:
        raise ValueError("max_bursts_per_chunk must be >= 1")
    stream = torch.as_tensor(stream)
    n_sp = mesh.shape["sp"]
    chunk_len = stream.shape[-1] // n_sp
    batch = stream.shape[0]
    b = _row_size(mesh, batch, "detect_bursts_sharded")
    if not 0 < halo <= chunk_len:
        raise ValueError(f"halo {halo} must be in (0, {chunk_len}], the shard width")
    lead = (2,) if planar else ()
    if planar:
        detect_topk, extract = pp.detect_bursts_topk_planar, pp.extract_bursts_planar
    else:
        detect_topk, extract = sync_ops.detect_bursts_topk, burst_ops.extract_bursts

    # each row's ring: its runs' windows, (b, [2,] n_run, W) on the run's device
    by_device: dict = {}
    for r in range(mesh.shape["dp"]):
        rows = stream[r * b : (r + 1) * b]
        runs = device_runs(mesh.devices[r])
        data = [move(rows[..., j0 * chunk_len : j1 * chunk_len], dev) for dev, j0, j1 in runs]
        for (dev, j0, j1), win in zip(runs, _extend_runs(data, chunk_len, halo)):
            if planar:
                win = win.transpose(1, 2)  # (b, n_run, 2, W)
            by_device.setdefault(dev, []).append((r, j0, j1, win.reshape((-1,) + lead
                                                                       + win.shape[-1:])))

    det_out = None
    for dev, parts in by_device.items():
        ext = torch.cat([p[-1] for p in parts]) if len(parts) > 1 else parts[0][-1]
        det = _rank_slots(detect_topk(cfg, ext, max_bursts=k + 1), chunk_len, k,
                          false_alarm_prob)
        n_win = ext.shape[0]
        rep = ext[:, None].expand((n_win, k) + ext.shape[1:]).reshape((-1,) + ext.shape[1:])
        bursts = extract(cfg, rep, {key: det[key].reshape(-1) for key in _VAL_KEYS})
        bursts = bursts.reshape((n_win, k) + bursts.shape[1:])
        if det_out is None:  # the outputs, gathered on the stream's device
            det_out = {key: torch.empty((batch, n_sp, k), dtype=det[key].dtype,
                                        device=stream.device) for key in _DET_KEYS}
            burst_out = torch.empty((batch, n_sp, k) + bursts.shape[2:],
                                    dtype=bursts.dtype, device=stream.device)
        at = 0
        for r, j0, j1, win in parts:
            n = win.shape[0]
            rows, cols = slice(r * b, (r + 1) * b), slice(j0, j1)
            for key in _DET_KEYS:
                det_out[key][rows, cols] = move(det[key][at : at + n], stream.device).reshape(
                    b, j1 - j0, k)
            burst_out[rows, cols] = move(bursts[at : at + n], stream.device).reshape(
                (b, j1 - j0, k) + bursts.shape[2:])
            at += n
    if k == 1:
        det_out = {key: v[..., 0] for key, v in det_out.items()}
        burst_out = burst_out[:, :, 0]
    return det_out, burst_out


def psum_metrics(metrics, group=None) -> dict:
    """Sum metric accumulators across shards, then across processes.

    ``metrics``: a dict of tensors, or a list of per-shard dicts (summed key
    by key on the first shard's device). With ``group`` (a
    ``torch.distributed`` process group, e.g. ``torch.distributed.group.
    WORLD``) the sum is then all-reduced over the group's processes; the
    group's backend must take the tensors' device (gloo: the CPU).
    """
    shards = [metrics] if isinstance(metrics, dict) else list(metrics)
    total = {}
    for key, value in shards[0].items():
        acc = torch.as_tensor(value).clone()
        for shard in shards[1:]:
            acc += move(torch.as_tensor(shard[key]), acc.device)
        total[key] = acc
    if group is not None:
        import torch.distributed as dist

        for v in total.values():
            dist.all_reduce(v, op=dist.ReduceOp.SUM, group=group)
    return total
