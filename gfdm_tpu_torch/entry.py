"""Main-path entry points: the burst link and the service's input stream.

``entry`` is the port's counterpart of ``__graft_entry__.entry`` at the
repository root: its step is the one-kernel link ``link_single_fused`` with
the matmul IC, the path the JAX package's ``bench.py`` times on its
accelerator. ``service_stream`` is the counterpart of
``bench._service_stream``: the burst-bearing chunk stream the streaming
receive service is measured on. ``large_k_config`` is the configuration of
``benchmarks/largek_crossover.py``, the large-K factored link's.
``cdd_link`` is the two-antenna link of ``examples/cdd_two_antenna.py``.
``dryrun_multichip`` and ``dryrun_multihost`` are the counterparts of
``__graft_entry__``'s: one sharded step on a (virtual) device mesh, and a
serve split over processes.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import GfdmConfig
from .device import resolve_device
from .kernels.fused import link_single_fused, receive_bursts_fused, tx_cdd_fused
from .ops.planar_pipeline import prepare, transmit_planar
from .ops.rx import constellation_points

__all__ = ["cdd_channel", "cdd_link", "dryrun_multichip", "dryrun_multihost", "entry",
           "large_k_config", "planar_payload", "service_stream"]

# examples/cdd_two_antenna.py's per-antenna multipath taps
CDD_TAPS = (np.array([1.0, 0.2 + 0.1j]), np.array([0.8 - 0.2j, 0.0, 0.15]))


def planar_payload(cfg: GfdmConfig, batch: int, seed: int = 0) -> np.ndarray:
    """(batch, 2, n_data) float32 planar QPSK payload from a numpy seed."""
    rng = np.random.default_rng(seed)
    qpsk = (rng.integers(0, 2, (batch, 2, cfg.n_data_symbols)) * 2 - 1) / np.sqrt(2.0)
    return qpsk.astype(np.float32)


def large_k_config(K: int) -> GfdmConfig:
    """The large-K crossover configuration at K subcarriers: M = 9, the
    canonical 52/64 active ratio, cp = K/4, cs = K/8 (K = 256, 512, 1024
    in the crossover study)."""
    return GfdmConfig(
        subcarriers=K,
        active_subcarriers=int(K * 0.78125),
        timeslots=9,
        cp_len=K // 4,
        cs_len=K // 8,
    )


def entry(device):
    """(fn, example_args): the forward step of the flagship link on ``device``.

    payload symbols -> Tx (map, modulate, CP+window, preamble) -> receiver
    (channel estimation, SNR/CNR, ZF, 2 IC iterations, demap) -> EVM.
    ``fn(data)`` returns (data_hat, snr_lin, evm). On a CUDA device the step
    runs the CUDA link kernel; on the CPU, its plain torch version.
    """
    device = torch.device(device)
    cfg = GfdmConfig()
    prepare(cfg, device=device)

    def step(data):
        return link_single_fused(cfg, data, ic_iterations=2, ic_mode="matmul")

    data = torch.from_numpy(planar_payload(cfg, batch=64, seed=0)).to(device)
    return step, (data,)


def service_stream(cfg: GfdmConfig, n_chunks: int, chunk_len: int, snr_db: float,
                   impaired: bool, rng: np.random.Generator, constellation: str = "qpsk"):
    """Synthesize a burst-bearing chunk stream for the receive service.

    Returns ``(chunks, counts, payload)``: (n_chunks, 2, chunk_len + halo)
    float32 halo-extended chunks, the bursts placed in each chunk, and the
    (n_bursts, 2, n_data) float32 payload of the bursts in placement
    order. With the default QPSK payload it makes the same ``rng`` calls in
    the same order as the JAX package's ``bench._service_stream``, so a seed
    gives the same counts, offsets, taps, CFOs and noise there and here;
    ``constellation="qam16"`` / ``"qam64"`` draws the payload from that
    constellation's points instead (``ops.rx.constellation_points``).

    Offsets are drawn from the owned range [0, chunk_len - cp_len): the
    service owns a burst whose xcorr peak (cp_len into the burst) lies
    before chunk_len. AWGN at ``snr_db`` per sample over the bursts' power.
    ``impaired`` adds per-burst 8-tap Rayleigh multipath, residual CFO up to
    +-0.2 subcarriers and mixed density: ~25% empty chunks and ~25%
    two-burst chunks (the first in the left third, the second in the right
    half), for a receiver with max_bursts_per_chunk=2.
    """
    halo = cfg.frame_len + cfg.cp_len
    ext = chunk_len + halo
    max_off = chunk_len - cfg.cp_len
    counts = (
        rng.choice([0, 1, 2], n_chunks, p=[0.25, 0.5, 0.25])
        if impaired
        else np.ones(n_chunks, np.int64)
    )
    n_bursts = int(counts.sum())
    if constellation == "qpsk":
        sym = (rng.integers(0, 2, (n_bursts, 2, cfg.n_data_symbols)) * 2 - 1) / np.sqrt(2.0)
    else:
        pts = constellation_points(constellation)
        idx = rng.integers(0, pts.size, (n_bursts, cfg.n_data_symbols))
        sym = np.stack([pts[idx].real, pts[idx].imag], axis=1)
    payload = sym.astype(np.float32)
    bursts = transmit_planar(cfg, torch.from_numpy(payload))[:, 0].numpy()
    bc = bursts[:, 0] + 1j * bursts[:, 1]
    if impaired:
        taps = (
            rng.standard_normal((n_bursts, 8)) + 1j * rng.standard_normal((n_bursts, 8))
        ) * (0.5 ** np.arange(8)) / np.sqrt(2.0)
        taps /= np.linalg.norm(taps, axis=1, keepdims=True)
        L = bc.shape[1]
        H = np.fft.fft(taps, L + 8, axis=1)
        bc = np.fft.ifft(np.fft.fft(bc, L + 8, axis=1) * H, axis=1)[:, : L + 7]
        cfo = rng.uniform(-0.2, 0.2, n_bursts)
        bc *= np.exp(
            2j * np.pi * cfo[:, None] * np.arange(bc.shape[1]) / cfg.subcarriers
        )
    blen = bc.shape[1]
    sig_power = float(np.mean(np.abs(bc) ** 2))  # per-sample signal power
    noise_amp = np.sqrt(sig_power * 10 ** (-snr_db / 10) / 2)
    stream = noise_amp * rng.standard_normal((n_chunks, 2, ext))
    bi = 0
    for i in range(n_chunks):
        if counts[i] == 1:
            pos = [rng.integers(0, max_off)]
        elif counts[i] == 2:
            pos = [rng.integers(0, chunk_len // 3 - cfg.cp_len),
                   rng.integers(chunk_len // 2 + cfg.frame_len // 2, max_off)]
        else:
            pos = []
        for p in pos:
            stream[i, 0, p : p + blen] += bc[bi].real
            stream[i, 1, p : p + blen] += bc[bi].imag
            bi += 1
    return stream.astype(np.float32), counts, payload


def _dynamic_range_chunks(cfg: GfdmConfig, chunk_len: int, rng: np.random.Generator,
                          drop_db: float = 60.0) -> np.ndarray:
    """(39, 2, chunk_len + halo) float32 chunks whose power steps by
    ``drop_db`` or more: detection inputs whose 2K windows hold terms of
    very different sizes.

    Rows 0-36 are friendly ``service_stream`` chunks (20 dB, one burst
    each) scaled by 10^(-drop_db / 20) from one sample on: a burst or its
    noise followed by near-silence, the step at 34 offsets spread over the
    chunk (every residue mod 8) and at 1,024, 2,047 and 2,048 (2,048: the
    edge of csrc/detect.cu's 2,048-position tiles). Row 37 is all zero; row 38
    is zero up to chunk_len // 2, then one noiseless burst, then zero.
    """
    steps = np.concatenate([np.linspace(1, chunk_len + cfg.frame_len + cfg.cp_len - 1,
                                        34).astype(int), [1024, 2047, 2048]])
    x, _counts, _payload = service_stream(cfg, steps.size + 1, chunk_len, 20.0, False, rng)
    for row, at in zip(x, steps):
        row[:, at:] *= np.float32(10.0 ** (-drop_db / 20.0))
    burst = transmit_planar(cfg, torch.from_numpy(planar_payload(cfg, 1, seed=1)))
    x[-1] = 0.0
    x[-1, :, chunk_len // 2 : chunk_len // 2 + cfg.frame_len] = burst[0, 0].numpy()
    return np.concatenate([x[:-1], np.zeros_like(x[-1:]), x[-1:]])


def _fir(x: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """(B, 2, T) planar signal through the complex FIR ``h``, truncated to T."""
    T = x.shape[-1]
    yr = torch.zeros_like(x[:, 0])
    yi = torch.zeros_like(x[:, 1])
    for lag, tap in enumerate(h):
        if tap == 0:
            continue
        xr = torch.nn.functional.pad(x[:, 0], (lag, 0))[:, :T]
        xi = torch.nn.functional.pad(x[:, 1], (lag, 0))[:, :T]
        yr = yr + float(tap.real) * xr - float(tap.imag) * xi
        yi = yi + float(tap.real) * xi + float(tap.imag) * xr
    return torch.stack([yr, yi], dim=1)


def cdd_channel(ports: torch.Tensor, snr_db: float, seed: int) -> torch.Tensor:
    """(B, n_ports, 2, frame_len) CDD ports -> (B, 2, frame_len) received
    bursts: ports 0 and 1 each through its own multipath (``CDD_TAPS``),
    summed, plus AWGN at ``snr_db`` over the received power (numpy, from
    ``seed``)."""
    rx = _fir(ports[:, 0], CDD_TAPS[0]) + _fir(ports[:, 1], CDD_TAPS[1])
    sigma = (float((rx**2).sum(dim=1).mean()) / 10 ** (snr_db / 10) / 2) ** 0.5
    noise = np.random.default_rng(seed).standard_normal(tuple(rx.shape), dtype=np.float32)
    return (rx + sigma * torch.from_numpy(noise).to(rx.device)).contiguous()


def cdd_link(cfg: GfdmConfig, data: torch.Tensor, snr_db: float, seed: int,
             ic_iterations: int = 4) -> torch.Tensor:
    """The two-antenna cyclic-delay-diversity link: ``tx_cdd_fused`` (ports
    0 and 1 of ``cfg.cyclic_shifts``) -> ``cdd_channel`` ->
    ``receive_bursts_fused``. Returns the data estimate (B, 2, n_data) on
    the payload's device."""
    rx = cdd_channel(tx_cdd_fused(cfg, data), snr_db, seed)
    return receive_bursts_fused(cfg, rx, ic_iterations=ic_iterations)["data"]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run ONE sharded end-to-end step on a virtual mesh of ``n_devices``
    copies of ``device`` (the card unless ``device="cpu"``).

    Shardings exercised, each shard group on a device as one batched call:
      - 'dp': bursts split over the mesh's rows (the throughput axis): the
        Tx, and the receiver with the EVM;
      - 'sp': the IQ stream's sample axis split over a row's columns, with
        the halo exchange, so bursts straddling chunk boundaries are found
        (``parallel.detect_bursts_sharded``), then the owner pick;
      - one step of the sp-sharded StreamingReceiver on the same mesh, whose
        boundary-straddling bursts must all be owned by shard 0.
    Prints __graft_entry__.dryrun_multichip's line; returns its figures.
    """
    from .parallel import detect_bursts_sharded, dp_map, make_mesh
    from .ops.planar_pipeline import receive_bursts_planar
    from .runtime.service import StreamingReceiver

    dev = resolve_device(device, "dryrun_multichip")
    sp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    dp = n_devices // sp
    mesh = make_mesh([dev] * n_devices, dp=dp, sp=sp)
    cfg = GfdmConfig()
    prepare(cfg, device=dev)

    batch = 2 * dp
    chunk_len = 1024
    data = torch.from_numpy(planar_payload(cfg, batch, seed=1)).to(dev)
    offset = chunk_len - cfg.frame_len // 2 if sp > 1 else 64

    def tx_step(d):
        # dp-sharded Tx: one burst per payload, placed in an sp-shardable stream
        bursts = transmit_planar(cfg, d)[:, 0]  # (B, 2, frame_len)
        stream = torch.zeros((d.shape[0], 2, sp * chunk_len), dtype=bursts.dtype,
                             device=d.device)
        stream[..., offset : offset + cfg.frame_len] = bursts
        return stream

    stream = dp_map(mesh, tx_step, data)
    # sp-sharded sync + extraction with the halo exchange
    det, bursts = detect_bursts_sharded(cfg, mesh, stream, halo=cfg.frame_len + 64,
                                        planar=True)
    # pick the owning chunk's burst (strongest FOUND = owned + CFAR-valid
    # detection) per stream: the left neighbour also sees the burst inside
    # its halo, but that detection has start >= chunk_len and found=False
    best = torch.argmax(det["strength"] * det["found"], dim=1)
    chosen = bursts[torch.arange(batch, device=bursts.device), best]

    def rx_step(b):
        return receive_bursts_planar(cfg, b, ic_iterations=2)["data"]

    d_hat = dp_map(mesh, rx_step, chosen)
    evm = float(torch.sqrt(((d_hat - data) ** 2).sum()
                           / torch.clamp_min((data**2).sum(), 1e-30)))
    if not np.isfinite(evm):
        raise RuntimeError("dry run produced a non-finite EVM")

    # the serve()-path form of the same shardings: one step of the
    # sp-sharded StreamingReceiver over the mesh
    sp_found = -1
    if sp > 1:
        svc_chunk = sp * chunk_len
        halo = cfg.frame_len + cfg.cp_len
        rx = StreamingReceiver(cfg, chunk_len=svc_chunk, batch_chunks=dp,
                               engine="fused", sp_shards=sp, mesh=mesh)
        ext_chunks = np.zeros((dp, 2, svc_chunk + halo), np.float32)
        ext_chunks[:, :, :svc_chunk] = stream[:dp].cpu().numpy()
        # light noise so the CFAR has a real noise floor (a silent stream
        # degenerates the threshold toward zero and every shard fires)
        rng = np.random.default_rng(2)
        ext_chunks += (0.02 * np.abs(ext_chunks).max()) * rng.standard_normal(
            ext_chunks.shape).astype(np.float32)
        out = rx.step(ext_chunks)
        # slots are (chunk, shard): the burst straddles the sub-chunk
        # boundary and is owned by shard 0 through the halo; shard 1 stays
        # quiet
        slot_found = out["found"].reshape(dp, sp)
        if not (slot_found[:, 0].all() and not slot_found[:, 1:].any()):
            raise RuntimeError(f"sp-sharded serve ownership wrong: {slot_found.tolist()}")
        sp_found = int(slot_found.sum())
    print(
        f"dryrun_multichip: mesh dp={dp} sp={sp}, batch={batch}, "
        f"chunk_len={chunk_len}, EVM={evm:.4f}, sp_serve_found={sp_found}"
    )
    return {"dp": dp, "sp": sp, "batch": batch, "chunk_len": chunk_len, "evm": evm,
            "sp_serve_found": sp_found}


def dryrun_multihost(n_processes: int = 2, device=None) -> dict:
    """Serve one burst stream split over ``n_processes`` OS processes in one
    torch.distributed (gloo) group, on the card unless ``device="cpu"``
    (processes may share the card), plus a one-process baseline
    (``parallel.multihost.launch``). Raises unless the payloads equal the
    baseline's and the metrics' sum agrees in every process; prints
    __graft_entry__.dryrun_multihost's line (on one shared card the
    efficiency measures contention, not scaling) and returns launch's dict.
    """
    from .parallel.multihost import launch

    dev = resolve_device(device, "dryrun_multihost")
    r = launch(num_processes=n_processes, n_chunks=16, timeout=540, device=dev.type)
    if not r["parity"]:
        raise RuntimeError("multi-process payloads diverged from the one-process run")
    if not r["psum_ok"]:
        raise RuntimeError("the cross-process metrics' sum disagreed")
    print(
        f"dryrun_multihost: {n_processes} processes, {r['n_chunks']} chunks, "
        f"{r['bursts_found']} bursts, parity OK, psum OK, "
        f"serve {r['serve_seconds_multi_max']*1e3:.1f} ms/host vs "
        f"{r['serve_seconds_single']*1e3:.1f} ms single, "
        f"efficiency {r['efficiency']:.2f}"
    )
    return r
