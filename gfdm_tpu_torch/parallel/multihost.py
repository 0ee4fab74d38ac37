"""Multi-process streaming receive: >= 2 OS processes, one torch.distributed group.

The port of ``gfdm_tpu.parallel.multihost``. Chunk batches are assigned to
processes in contiguous time ranges (``runtime.service.host_chunk_range``),
each process serves its range on its local device mesh, and steady-state
reception needs no collective: the processes exchange only the aggregated
metrics.

  - worker (``python -m gfdm_tpu_torch.parallel.multihost --process-id I
    --num-processes N --coordinator host:port --out-dir D [--n-chunks]
    [--batch-chunks] [--device {cuda,cpu}]``): joins a gloo group
    (``runtime.service.init_distributed``), builds the same deterministic
    burst stream as every other process, serves its chunk range through a
    StreamingReceiver on its local mesh (every visible card, or the CPU),
    all-reduces (bursts, chunks, samples) over the group, and writes its
    payloads and timings to ``D/proc<I>.npz``.

  - ``launch(num_processes, ...)``: spawns the workers on a local
    coordinator, then a one-process baseline, and returns payload parity,
    the metrics' agreement and the serve times.

Processes may share one card, each with its own CUDA context; then
``efficiency`` measures their contention for the card, not scaling.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

__all__ = ["launch", "worker_main", "build_stream_chunks"]

_CHUNK_LEN = 2048


def build_stream_chunks(cfg, n_chunks: int, seed: int = 9, device=None):
    """Deterministic halo-extended chunk batch shared by every process.

    One burst in each chunk except every 5th (kept empty so the CFAR
    rejection path is exercised too); the bursts are modulated on
    ``device`` (the card unless ``device="cpu"``). Returns (chunks (n, 2,
    ext) float32, expected payload planar array, expected found mask).
    """
    import torch

    from ..ops import planar as pl
    from ..ops import tx as tx_ops
    from ..ref import utils
    from ..runtime.stream import chunk_with_lookahead

    halo = cfg.frame_len + cfg.cp_len
    rng = np.random.default_rng(seed)
    data = np.stack([
        utils.random_qpsk(cfg.n_data_symbols, seed=seed + 100 + i)
        for i in range(n_chunks)
    ]).astype(np.complex64)
    bursts = tx_ops.transmit(cfg, data, device=device)[:, 0, :].cpu().numpy()

    stream = 0.01 * (
        rng.standard_normal(n_chunks * _CHUNK_LEN)
        + 1j * rng.standard_normal(n_chunks * _CHUNK_LEN)
    ).astype(np.complex64)
    expect_found = np.ones(n_chunks, dtype=bool)
    for i in range(n_chunks):
        if i % 5 == 4:
            expect_found[i] = False
            continue
        off = i * _CHUNK_LEN + 97 + (i * 131) % 600
        stream[off : off + cfg.frame_len] += bursts[i]

    planar = torch.from_numpy(pl.to_planar(stream))
    chunks = np.moveaxis(chunk_with_lookahead(planar, _CHUNK_LEN, halo).numpy(), -2, -3)
    return chunks.astype(np.float32), pl.to_planar(data).astype(np.float32), expect_found


def _local_devices(device: str) -> list:
    """The worker's local mesh: every visible card, or the CPU."""
    import torch

    if device == "cpu":
        return [torch.device("cpu")]
    from ..parallel.mesh import make_mesh

    return list(make_mesh().devices.flat)


def _serve_range(cfg, chunks, lo: int, hi: int, batch_chunks: int, device: str = "cuda"):
    """Serve chunks[lo:hi] through a local-mesh StreamingReceiver.

    Returns (per-slot host outputs dict, wall seconds after a warm-up step,
    the stats of the timed serve).
    """
    from ..parallel.mesh import make_mesh
    from ..runtime.service import ServiceStats, StreamingReceiver

    devs = _local_devices(device)
    rx = StreamingReceiver(cfg, chunk_len=_CHUNK_LEN,
                           batch_chunks=max(batch_chunks, len(devs)),
                           mesh=make_mesh(devs, dp=len(devs), sp=1))
    rx.step(chunks[lo : lo + rx.batch_chunks])  # warm-up: constants, handles
    rx.stats = ServiceStats()  # the warm-up counts toward no metric

    got = []
    idx = lo

    def source():
        nonlocal idx
        if idx >= hi:
            return None
        batch = chunks[idx : min(idx + rx.batch_chunks, hi)]
        base = idx * _CHUNK_LEN
        idx += batch.shape[0]
        return batch, base

    t0 = time.perf_counter()
    rx.serve(source, sink=got.append)
    dt = time.perf_counter() - t0

    out = {key: np.concatenate([g[key] for g in got])
           for key in ("found", "data", "start_abs", "snr_lin")}
    return out, dt, rx.stats


def worker_main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one process of a multi-process serve")
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--coordinator", required=True, help="host:port of rank 0")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--n-chunks", type=int, default=24)
    p.add_argument("--batch-chunks", type=int, default=4)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from ..config import GfdmConfig
    from ..parallel.mesh import psum_metrics
    from ..runtime.service import host_chunk_range, init_distributed

    init_distributed(coordinator_address=args.coordinator,
                     num_processes=args.num_processes, process_id=args.process_id)
    try:
        cfg = GfdmConfig()
        chunks, _, _ = build_stream_chunks(cfg, args.n_chunks, device=args.device)
        r = host_chunk_range(args.n_chunks, args.num_processes, args.process_id)
        out, dt, stats = _serve_range(cfg, chunks, r.start, r.stop, args.batch_chunks,
                                      args.device)
        # the one cross-process exchange: the metrics' sum over the group
        totals = psum_metrics({
            "bursts": torch.tensor(int(out["found"].sum()), dtype=torch.int64),
            "chunks": torch.tensor(stats.chunks, dtype=torch.int64),
            "samples": torch.tensor(stats.samples, dtype=torch.int64),
        }, group=dist.group.WORLD)
        os.makedirs(args.out_dir, exist_ok=True)
        np.savez(
            os.path.join(args.out_dir, f"proc{args.process_id}.npz"),
            found=out["found"], data=out["data"], start_abs=out["start_abs"],
            snr_lin=out["snr_lin"], serve_seconds=dt,
            chunk_lo=r.start, chunk_hi=r.stop,
            global_bursts=int(totals["bursts"]), global_chunks=int(totals["chunks"]),
            global_samples=int(totals["samples"]),
            process_count=dist.get_world_size(),
        )
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(n_procs: int, gdir: str, n_chunks: int, batch_chunks: int,
               device: str, timeout: float) -> list:
    """Run ``n_procs`` workers on a fresh local coordinator; their npz files.
    A failed or late worker raises, after every worker is killed."""
    port = _free_port()
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])  # the package's parent
    env["PYTHONPATH"] = os.pathsep.join([root] + [p for p in [env.get("PYTHONPATH")] if p])
    if device == "cpu":  # one intra-op thread a worker: they share the cores
        env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "gfdm_tpu_torch.parallel.multihost",
             "--process-id", str(i), "--num-processes", str(n_procs),
             "--coordinator", f"127.0.0.1:{port}", "--out-dir", gdir,
             "--n-chunks", str(n_chunks), "--batch-chunks", str(batch_chunks),
             "--device", device],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for i in range(n_procs)
    ]
    deadline = time.monotonic() + timeout
    try:
        for i, pr in enumerate(procs):
            try:
                _, err = pr.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"{gdir}: worker {i} timed out after {timeout} s") from None
            if pr.returncode != 0:
                raise RuntimeError(f"{gdir}: worker {i} failed rc={pr.returncode}:\n"
                                   + err.decode(errors="replace")[-2000:])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    return [np.load(os.path.join(gdir, f"proc{i}.npz")) for i in range(n_procs)]


def launch(num_processes: int = 2, n_chunks: int = 24, out_dir: str | None = None,
           timeout: float = 600.0, device: str = "cuda", batch_chunks: int = 4) -> dict:
    """Spawn a multi-process run and a one-process baseline; check and time.

    Returns {"parity", "psum_ok", "bursts_found", "serve_seconds_multi_max",
    "serve_seconds_single", "efficiency", ...}. Raises on a worker failure
    or a timeout, with every worker killed. On a card the kernel library is
    built here first, so the workers find it built.
    """
    import tempfile

    if device == "cuda":
        from ..device import resolve_device
        from ..kernels import cuda_lib

        resolve_device(None, "launch")
        cuda_lib.library()
    own_dir = out_dir is None
    if own_dir:
        out_dir = tempfile.mkdtemp(prefix="gfdm_multihost_")

    def run(n_procs):
        return _run_group(n_procs, os.path.join(out_dir, f"n{n_procs}"), n_chunks,
                          batch_chunks, device, timeout)

    multi = run(num_processes)
    base = run(1)[0]

    # payload parity: the processes' ranges in order ARE chunk order, slot
    # for slot
    m_found = np.concatenate([m["found"] for m in multi])
    m_data = np.concatenate([m["data"] for m in multi])
    m_start = np.concatenate([m["start_abs"] for m in multi])
    parity = (
        bool((m_found == base["found"]).all())
        and bool((m_start[m_found] == base["start_abs"][base["found"]]).all())
        and bool(np.allclose(m_data[m_found], base["data"][base["found"]], atol=1e-5))
    )
    t_multi = max(float(m["serve_seconds"]) for m in multi)
    t_base = float(base["serve_seconds"])
    efficiency = t_base / (num_processes * t_multi) if t_multi > 0 else 0.0
    expect_bursts = int(base["found"].sum())
    psum_ok = all(
        int(m["global_bursts"]) == expect_bursts
        and int(m["global_chunks"]) == n_chunks
        and int(m["process_count"]) == num_processes
        for m in multi
    )
    result = {
        "num_processes": num_processes,
        "n_chunks": n_chunks,
        "device": device,
        "parity": parity,
        "psum_ok": psum_ok,
        "bursts_found": expect_bursts,
        "serve_seconds_multi_max": t_multi,
        "serve_seconds_single": t_base,
        "efficiency": efficiency,
    }
    if own_dir:
        with open(os.path.join(out_dir, "summary.json"), "w") as f:
            json.dump(result, f, indent=1)
        result["out_dir"] = out_dir
    return result


if __name__ == "__main__":
    sys.exit(worker_main())
