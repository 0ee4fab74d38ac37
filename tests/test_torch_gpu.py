"""Each CUDA kernel of gfdm_tpu_torch against its plain torch version, on the card.

Imports torch and the port only, so it runs on a machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py tests/test_torch_entry.py

Without a CUDA device every test skips. These hold each kernel to its
plain version at the shapes and options around the main paths: ragged and
small batches, other configs, every option. chip_smoke.py's phase 3 holds
them at the main paths' own shapes (65,536 bursts, the service's 4,096
chunks) through gfdm_tpu_torch/benchmarks/kernels.py's table of checks,
which that script also times.
"""
import ctypes

import numpy as np
import pytest
import torch

from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import large_k_config, planar_payload
from gfdm_tpu_torch.kernels import fused
import factored_fft_emulation as emu
from dyadic_llrs import dyadic_llrs, noisy_llrs

pytestmark = pytest.mark.gpu

B = 1027  # not a multiple of the stages' 128-burst tile: masked
CONFIGS = {
    "canonical": GfdmConfig(),
    "k32m5": GfdmConfig(subcarriers=32, active_subcarriers=24, timeslots=5,
                        cp_len=8, cs_len=4),
}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _payload(cfg, seed, dev):
    return torch.from_numpy(planar_payload(cfg, B, seed)).to(dev)


def _max_err(a, b):
    return float((a.reshape(b.shape) - b).abs().max())


# the Tx kernel's cases: batches at its 64-burst tile's edges; configs with
# a ragged column tile (k32m5: N = 160), an xi plane 520 bytes into a row
# and a ragged k-tile (n130: n_data = 130), and N = 1,152 / 4,608 at large K
TX_BATCHES = (1, 63, 64, 65, 1027, 8320)
TX_CONFIGS = {
    "canonical": GfdmConfig(),
    "k32m5": CONFIGS["k32m5"],
    "n130": GfdmConfig(subcarriers=32, active_subcarriers=26, timeslots=5, cp_len=8,
                       cs_len=8),
    "K128": large_k_config(128),
    "K512": large_k_config(512),
}
TX_SHIFTS = ((0, 4), (0, 3, 7))


def _tx_cases(shift_sets, ports=None):
    """(config, shifts, batch[, shift index]) cases whose shifts fit the CS;
    ``ports(shifts)`` gives the shift indices of a one-port case."""
    cases = []
    for name, cfg in TX_CONFIGS.items():
        for shifts in (s for s in shift_sets if max(s) <= cfg.cs_len):
            for batch in TX_BATCHES:
                tag = f"{name}-{'_'.join(map(str, shifts))}-B{batch}"
                if ports is None:
                    cases.append(pytest.param(name, shifts, batch, id=tag))
                else:
                    cases += [pytest.param(name, shifts, batch, si, id=f"{tag}-port{si}")
                              for si in ports(shifts)]
    return cases


def _tx_payload(cfg, batch, seed, dev):
    return torch.from_numpy(planar_payload(cfg, batch, seed)).to(dev)


@pytest.mark.parametrize("name,shifts,batch,shift_index",
                         _tx_cases(TX_SHIFTS, lambda s: (0, len(s) - 1)))
def test_tx_kernel_matches_plain(name, shifts, batch, shift_index):
    dev = _cuda()
    cfg = TX_CONFIGS[name].replace(cyclic_shifts=shifts)
    data = _tx_payload(cfg, batch, 60, dev)
    before = fused.LAUNCHES["tx"]
    got = fused.tx_frame_fused(cfg, data, shift_index=shift_index)
    assert fused.LAUNCHES["tx"] == before + 1
    ref = fused._tx_frame_plain(cfg, data.reshape(batch, -1), shift_index)
    err = _max_err(got, ref)
    print(f"tx[{name},B={batch},shift={shifts[shift_index]}] max_abs={err:.3e} "
          f"bit_equal={err == 0.0}")
    assert err < 2e-5


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
def test_rx_kernel_matches_plain(ic_mode, name):
    dev = _cuda()
    cfg = CONFIGS[name]
    bursts = fused.tx_frame_fused(cfg, _payload(cfg, 70, dev))
    gen = torch.Generator(dev).manual_seed(0)
    bursts = bursts + 0.05 * torch.randn(bursts.shape, device=dev, generator=gen)
    before = fused.LAUNCHES["rx"]
    sent = bursts.clone()
    chan, sym, met = fused.rx_receiver_fused(cfg, bursts, ic_mode=ic_mode)
    assert fused.LAUNCHES["rx"] == before + fused.rx_launches(2)
    assert torch.equal(bursts, sent)  # read in place, never written
    rchan, rsym, rmet = fused._rx_receiver_plain(cfg, bursts.reshape(B, -1), 2, ic_mode)
    assert _max_err(chan, rchan) < 2e-4
    assert _max_err(sym, rsym) < 5e-4
    rel = ((met[:, 0] - rmet[:, 0]).abs() / rmet[:, 0].abs()).max()
    assert float(rel) < 1e-3
    # the active subcarriers' CNRs after the SNR, then zero padding
    n_cnr = fused._met_layout(cfg)[0]
    cnr, rcnr = met[:, 1 : 1 + n_cnr], rmet[:, 1 : 1 + n_cnr]
    assert float(((cnr - rcnr).abs() / (rcnr.abs() + 1e-12)).max()) < 1e-2
    assert not met[:, 1 + n_cnr :].any()


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
def test_link_kernel_matches_plain(ic_mode, name):
    dev = _cuda()
    cfg = CONFIGS[name]
    data = _payload(cfg, 80, dev)
    before = fused.LAUNCHES["link"]
    d_hat, _snr, evm = fused.link_single_fused(cfg, data, ic_mode=ic_mode)
    assert fused.LAUNCHES["link"] == before + fused.link_launches(ic_mode, 2)
    ref, _met = fused._link_single_plain(cfg, data.reshape(B, -1), 2, ic_mode)
    assert _max_err(d_hat, ref) < 1e-4
    assert 0.0 < float(evm) < 0.025


@pytest.mark.parametrize("batch", [80, 130, 4099])
@pytest.mark.parametrize("K", [128, 256, 512])
def test_rx_and_link_kernels_at_large_n_match_plain(K, batch):
    """N = 1152, 2304 and 4608: the receiver and the link in their 128-burst
    tiles (the JAX package runs its dense kernels there too) at batches that
    are not a multiple of 128 (80: one partial tile); the ragged last tile
    is masked."""
    from gfdm_tpu_torch.entry import large_k_config

    dev = _cuda()
    cfg = large_k_config(K)
    data = torch.from_numpy(planar_payload(cfg, batch, 90)).to(dev)
    bursts = fused.tx_frame_fused(cfg, data)
    gen = torch.Generator(dev).manual_seed(1)
    bursts = bursts + 0.01 * torch.randn(bursts.shape, device=dev, generator=gen)
    before = dict(fused.LAUNCHES)
    chan, sym, _met = fused.rx_receiver_fused(cfg, bursts)
    d_hat, _snr, evm = fused.link_single_fused(cfg, data)
    assert fused.LAUNCHES["rx"] == before["rx"] + fused.rx_launches(2)
    assert fused.LAUNCHES["link"] == before["link"] + fused.link_launches("conv", 2)
    rchan, rsym, _rmet = fused._rx_receiver_plain(cfg, bursts.reshape(batch, -1), 2, "conv")
    assert _max_err(chan, rchan) < 2e-4
    assert _max_err(sym, rsym) < 5e-4
    ref, _met = fused._link_single_plain(cfg, data.reshape(batch, -1), 2, "conv")
    assert _max_err(d_hat, ref) < 1e-4
    assert 0.0 < float(evm) < 0.025


def test_rx_and_link_kernels_refuse_k1024():
    """N = 9216: the dense stacks would take 1 GB each, so both wrappers
    raise before building any, naming the factored receiver and link."""
    from gfdm_tpu_torch.entry import large_k_config

    dev = _cuda()
    cfg = large_k_config(1024)
    before = dict(fused.LAUNCHES)
    with pytest.raises(ValueError, match="rx_receiver_fused: N = 9216.*rx_receiver_factored"):
        fused.rx_receiver_fused(cfg, torch.zeros(4, 2, cfg.frame_len, device=dev))
    with pytest.raises(ValueError, match="link_single_fused: N = 9216.*link_step_factored"):
        fused.link_single_fused(cfg, torch.zeros(4, 2, cfg.n_data_symbols, device=dev))
    assert fused.LAUNCHES == before
    assert not any(key[0] == cfg for key in fused._KERNEL_CONSTS)


# ---------------------------------------------------------------------------
# factored (large-K) kernels
# ---------------------------------------------------------------------------
B_FACTORED = 37  # ragged: one CTA a burst


def _factored_bursts(cfg, dev, seed, batch=B_FACTORED):
    data = torch.from_numpy(planar_payload(cfg, batch, seed)).to(dev)
    bursts = fused._tx_factored_plain(cfg, data, 0)
    rng = np.random.default_rng(seed + 1)
    noise = rng.standard_normal(tuple(bursts.shape)).astype(np.float32)
    return data, bursts + 0.01 * torch.from_numpy(noise).to(dev)


# IC iterations: none, one (a single iteration decides on d0 and writes the
# symbols over it), the default two, and three
FACTORED_IC = [0, 1, 2, 3]


# the K-point stage's paths: an FFT for K a power of two, the direct DFT for
# K = 96 (whose plain link on the CPU gives every decision back, EVM 0.018);
# the kernels' M = 9 instantiation, and at M = 5 the one for any M (plain
# link on the CPU: every decision back, EVM 0.021), with 16-byte planes and,
# at n_data = 250, frame_len = 466 and a data section 143 samples in, 4-byte
# ones (EVM 0.021)
FACTORED_CONFIGS = {
    "K256": large_k_config(256),
    "K512": large_k_config(512),
    "K1024": large_k_config(1024),
    "K96_direct": GfdmConfig(subcarriers=96, active_subcarriers=72, timeslots=9),
    "K128_M5": GfdmConfig(subcarriers=128, active_subcarriers=100, timeslots=5, cp_len=32,
                          cs_len=16),
    "K64_M5_unaligned": GfdmConfig(subcarriers=64, active_subcarriers=50, timeslots=5,
                                   cp_len=6, cs_len=3),
}


# the receiver with its own estimator (two launches: the estimator GEMM,
# then the receiver on its channel): the canonical config, K = 128 (the
# main path's), K = 96 (the direct DFT) and K = 64 at M = 5 with cp_len 6
# (4-byte copies of the preamble windows); one row tile of the GEMM (37
# bursts) and three, the last ragged (130)
ESTIMATOR_CONFIGS = {
    "canonical": CONFIGS["canonical"],
    "K128": large_k_config(128),
    **{name: FACTORED_CONFIGS[name] for name in ("K96_direct", "K64_M5_unaligned")},
}


@pytest.mark.parametrize("batch", [B_FACTORED, 130])
@pytest.mark.parametrize("ic_iterations", FACTORED_IC)
@pytest.mark.parametrize("name", list(ESTIMATOR_CONFIGS))
def test_rx_factored_kernel_with_estimator_matches_plain(name, ic_iterations, batch):
    dev = _cuda()
    cfg = ESTIMATOR_CONFIGS[name]
    _data, bursts = _factored_bursts(cfg, dev, 100 + cfg.subcarriers, batch)
    before = dict(fused.LAUNCHES)
    chan, sym = fused.rx_receiver_factored(cfg, bursts, ic_iterations, estimator="fused")
    assert fused.LAUNCHES["rx_factored"] == before["rx_factored"] + 1
    assert fused.LAUNCHES["rx_factored_chan"] == before["rx_factored_chan"] + 1
    rchan, rsym = fused._rx_factored_plain(cfg, bursts, None, ic_iterations)
    assert _max_err(chan, rchan) < 2e-4
    assert _max_err(sym, rsym) < 5e-4


# the estimator GEMM alone against a float64 product, at its copy widths
# (tests/test_torch_estimator_tiles.py replays its tiles on the CPU): 16-byte
# copies (canonical, K = 128; K = 96 with half a column tile), 4-byte
# copies of A (K64_M5_unaligned) and of E_W with 4-byte stores (K = 33, M =
# 5: N = 165), at ragged row tiles
ESTIMATE_GEMM_CONFIGS = {
    **ESTIMATOR_CONFIGS,
    "K33_M5_odd_n": GfdmConfig(subcarriers=33, active_subcarriers=26, timeslots=5, cp_len=7,
                               cs_len=4),
}


@pytest.mark.parametrize("batch", [1, 63, 65, 130])
@pytest.mark.parametrize("name", list(ESTIMATE_GEMM_CONFIGS))
def test_rx_estimate_gemm_matches_float64(name, batch):
    dev = _cuda()
    cfg = ESTIMATE_GEMM_CONFIGS[name]
    _data, bursts = _factored_bursts(cfg, dev, 400 + batch, batch)
    before = dict(fused.LAUNCHES)
    chan = fused._rx_estimate_cuda(cfg, bursts)
    assert fused.LAUNCHES["rx_factored"] == before["rx_factored"] + 1
    K = cfg.subcarriers
    pre2 = bursts[..., cfg.cp_len : cfg.cp_len + 2 * K].reshape(batch, 4 * K).double()
    ref = (pre2 @ fused._estimator_op(cfg, dev).double()).reshape(chan.shape)
    assert _max_err(chan, ref.float()) < 1e-5 * float(ref.abs().max())
    assert _max_err(chan, fused._rx_estimate_plain(cfg, bursts)) < 2e-4


@pytest.mark.parametrize("ic_iterations", FACTORED_IC)
@pytest.mark.parametrize("name", list(FACTORED_CONFIGS))
def test_factored_tx_and_fast_receiver_kernels_match_plain(name, ic_iterations):
    dev = _cuda()
    cfg = FACTORED_CONFIGS[name]
    assert bool(emu.fft_plan(cfg.subcarriers)) == (name != "K96_direct")
    data, bursts = _factored_bursts(cfg, dev, 200 + cfg.subcarriers)
    before = dict(fused.LAUNCHES)
    tx = fused.tx_frame_factored(cfg, data)
    assert fused.LAUNCHES["tx_factored"] == before["tx_factored"] + 1
    assert _max_err(tx, fused._tx_factored_plain(cfg, data, 0)) < 2e-5
    chan, sym = fused.rx_receiver_factored(cfg, bursts, ic_iterations, estimator="fast")
    assert fused.LAUNCHES["rx_factored_chan"] == before["rx_factored_chan"] + 1
    assert fused.LAUNCHES["rx_factored"] == before["rx_factored"]
    rchan, rsym = fused._rx_factored_plain(cfg, bursts, chan, ic_iterations)
    assert torch.equal(chan, rchan)
    assert _max_err(sym, rsym) < 5e-4
    # the clean link through both kernels gives every hard decision back
    d_hat, evm = fused.link_step_factored(cfg, data)
    assert torch.equal(torch.sign(d_hat), torch.sign(data))
    assert 0.0 < float(evm) < 0.025


@pytest.mark.parametrize("K", [32, 64, 96, 128, 256, 512, 1024, 2048])
def test_factored_plan_is_the_librarys(K):
    """The built library's K-point plan (row stride, FFT radices; none for
    the direct DFT) is the one tests/factored_fft_emulation.py replays."""
    import ctypes

    from gfdm_tpu_torch.kernels.cuda_lib import library

    _cuda()
    out = (ctypes.c_int * 8)()
    passes = library().gfdm_factored_plan(K, out)
    assert (out[0], tuple(out[1 : 1 + passes])) == (emu.row_stride(K), emu.fft_plan(K))


def test_rx_estimate_tile_is_the_librarys():
    """The built library's estimator GEMM tile (bursts, columns, k-depth of
    a CTA) is the one tests/test_torch_estimator_tiles.py replays."""
    import ctypes

    from gfdm_tpu_torch.kernels.cuda_lib import library
    from test_torch_estimator_tiles import BK, BM, BN

    _cuda()
    out = (ctypes.c_int * 3)()
    library().gfdm_rx_estimate_tile(out)
    assert tuple(out) == (BM, BN, BK)


def test_factored_kernels_refuse_k2048():
    """K = 2048 needs 331,400 B (Tx, and the receiver with the channel read:
    twiddles, two stages of nine padded rows and the M-point constants) of
    shared memory for one burst, beyond the 232,448 a CTA may have: each
    launch is refused and its wrapper raises, naming the kernel and the
    bytes."""
    dev = _cuda()
    cfg = large_k_config(2048)
    before = dict(fused.LAUNCHES)
    with pytest.raises(RuntimeError, match="gfdm_tx_factored kernel failed to launch"
                                           ".*the tx_factored kernel keeps 331400 B"):
        fused.tx_frame_factored(cfg, torch.zeros(2, 2, cfg.n_data_symbols, device=dev))
    bursts = torch.zeros(2, 2, cfg.frame_len, device=dev)
    with pytest.raises(RuntimeError, match="gfdm_rx_factored_chan kernel failed to launch"
                                           ".*the rx_factored_chan kernel keeps 331400 B"):
        fused.rx_receiver_factored(cfg, bursts, estimator="fast")
    assert fused.LAUNCHES == before


def test_factored_kernels_count_nothing_for_an_empty_batch():
    """The library launches nothing for B = 0, so no factored kernel is
    counted; the outputs are empty of the right shape."""
    dev = _cuda()
    cfg = large_k_config(128)
    before = dict(fused.LAUNCHES)
    bursts = fused.tx_frame_factored(cfg, torch.zeros(0, 2, cfg.n_data_symbols, device=dev))
    assert bursts.shape == (0, 2, cfg.frame_len)
    for est in ("fused", "fast"):
        chan, sym = fused.rx_receiver_factored(cfg, bursts, 2, estimator=est)
        assert chan.shape == sym.shape == (0, 2, cfg.block_len)
    assert fused.LAUNCHES == before


# ---------------------------------------------------------------------------
# detection kernels and the streaming service
# ---------------------------------------------------------------------------
N_CHUNKS = 37  # ragged: not a multiple of anything the kernels tile by
TRACE_TOL = dict(atol=3e-5, rtol=3e-3)  # the JAX package's Pallas limits
PEAK_TOL = dict(atol=1e-6, rtol=1e-4)


# the detection kernels' inputs: 37 service chunks (trim 0 or 5 samples:
# T not 128-aligned), the replay's power steps of 60 dB with an all-zero
# chunk and a burst after silence (entry._dynamic_range_chunks), and one
# long chunk: five tiles of 2,048 positions for either kernel, n_valid not
# a multiple of the tile and below n_ac
DETECT_CASES = ("trim0", "trim5", "dynamic", "long")


def _chunks(cfg, dev, case="trim0"):
    """(chunks on ``dev``, search limit) of a detection case."""
    from gfdm_tpu_torch.entry import _dynamic_range_chunks, service_stream

    if case == "dynamic":
        stream = _dynamic_range_chunks(cfg, 2048, np.random.default_rng(11))
        return torch.from_numpy(stream).to(dev), 2048
    n, chunk = (1, 9000) if case == "long" else (N_CHUNKS, 2048)
    stream, _counts, _pay = service_stream(cfg, n, chunk, 20.0, False,
                                           np.random.default_rng(7))
    trim = int(case.removeprefix("trim")) if case.startswith("trim") else 0
    stream = stream[..., : stream.shape[-1] - trim]
    return torch.from_numpy(np.ascontiguousarray(stream)).to(dev), chunk


def _close(a, b, atol, rtol):
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("case", DETECT_CASES)
def test_detect_front_kernel_matches_plain(name, case):
    from gfdm_tpu_torch.kernels import detect

    dev = _cuda()
    cfg = CONFIGS[name]
    s, limit = _chunks(cfg, dev, case)
    before = detect.LAUNCHES["detect_front"]
    got = detect.detect_front_fused(cfg, s, limit)
    assert detect.LAUNCHES["detect_front"] == before + 1
    n_valid = min(s.shape[-1] - 2 * cfg.subcarriers, limit)
    ref = detect._detect_front_plain(cfg, s, n_valid)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _close(g, r, **TRACE_TOL)
    assert torch.equal(torch.argmax(got[0], dim=-1), torch.argmax(ref[0], dim=-1))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("case", DETECT_CASES)
def test_detect_lean_kernel_matches_plain(name, case):
    from gfdm_tpu_torch.kernels import detect

    dev = _cuda()
    cfg = CONFIGS[name]
    s, limit = _chunks(cfg, dev, case)
    before = detect.LAUNCHES["detect_lean"]
    got = detect.detect_bursts_fused(cfg, s, limit)
    assert detect.LAUNCHES["detect_lean"] == before + 1
    n_valid = min(s.shape[-1] - 2 * cfg.subcarriers, limit)
    gated, ic = detect._detect_lean_plain(cfg, s, n_valid)
    g2, ic2 = detect._detect_lean_cuda(cfg, s, n_valid)
    assert _close(g2, gated, **TRACE_TOL) and _close(ic2, ic, **TRACE_TOL)
    # the plain epilogue on the plain traces: the wrapper on a CPU copy
    ref = detect.detect_bursts_fused(cfg, s.cpu(), limit)
    assert torch.equal(got["start"].cpu(), ref["start"])
    for key in ("cfo", "scale", "strength", "ac_peak", "noise_floor"):
        assert _close(got[key].cpu(), ref[key], **PEAK_TOL), key


@pytest.mark.parametrize("impl", ["pallas2", "pallas", "twostage"])
def test_streaming_service_fused_engine_on_card(impl, monkeypatch):
    from gfdm_tpu_torch.entry import service_stream
    from gfdm_tpu_torch.kernels import detect
    from gfdm_tpu_torch.ops import planar_pipeline as pp
    from gfdm_tpu_torch.runtime.service import StreamingReceiver

    dev = _cuda()
    cfg = CONFIGS["canonical"]
    stream, counts, _pay = service_stream(cfg, 64, 2048, 20.0, False,
                                          np.random.default_rng(3))
    monkeypatch.setattr(pp, "DETECT_IMPL", impl)
    before = dict(detect.LAUNCHES)
    rx = StreamingReceiver(cfg, chunk_len=2048, batch_chunks=64, engine="fused",
                           device=dev)
    out = rx.step(stream)
    # the step only enqueues work: a host sync inside it raises
    chunks = torch.from_numpy(stream).to(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        rx._step(chunks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    key = {"pallas2": "detect_lean", "pallas": "detect_front"}.get(impl)
    if key is not None:
        assert detect.LAUNCHES[key] == before[key] + 2
    else:
        assert detect.LAUNCHES == before
    assert out["found"].sum() == counts.sum() == 64


def test_detect_tile_is_the_librarys():
    """The built library's detection tile (threads of a CTA, consecutive
    positions a thread) is the one tests/test_torch_detect_tiles.py
    replays, and the wrapper pads the taps to a multiple of the 2R taps
    the FIR reads a step."""
    import ctypes

    from gfdm_tpu_torch.kernels import detect
    from gfdm_tpu_torch.kernels.cuda_lib import library
    from test_torch_detect_tiles import R, TP

    _cuda()
    out = (ctypes.c_int * 2)()
    library().gfdm_detect_tile(out)
    assert tuple(out) == (TP, R)
    assert detect._TAP_PAD % (2 * R) == 0


def test_detection_kernels_at_k8192_match_plain():
    """K = 8192 (16,384 taps): the sample window, 195 KB of shared memory a
    CTA, fits since the taps are read through L1 (a kernel that stages the
    taps too refuses K above ~7,000 at cp_len 16)."""
    from gfdm_tpu_torch.kernels import detect

    dev = _cuda()
    cfg = GfdmConfig(subcarriers=8192, active_subcarriers=8000, timeslots=3)
    rng = np.random.default_rng(5)
    s = torch.from_numpy(rng.standard_normal((2, 2, 2 * 8192 + 300), dtype=np.float32)).to(dev)
    got = detect.detect_front_fused(cfg, s, 200)
    for g, r in zip(got, detect._detect_front_plain(cfg, s, 200)):
        assert _close(g, r, **TRACE_TOL)
    gated, ic = detect._detect_lean_cuda(cfg, s, 200)
    ref = detect._detect_lean_plain(cfg, s, 200)
    assert _close(gated, ref[0], **TRACE_TOL) and _close(ic, ref[1], **TRACE_TOL)


def test_detection_tile_too_large_for_shared_memory_raises():
    """K = 16384 needs ~359 KB of shared memory a CTA (the 2K-sample windows
    of its 2,048 positions): the launch is refused and each wrapper raises,
    naming its kernel."""
    from gfdm_tpu_torch.kernels import detect

    dev = _cuda()
    cfg = GfdmConfig(subcarriers=16384, active_subcarriers=16000, timeslots=3)
    s = torch.zeros(2, 2, 2 * 16384 + 300, device=dev)
    before = dict(detect.LAUNCHES)
    with pytest.raises(RuntimeError, match="gfdm_detect_lean kernel failed to launch"
                                           ".*the detect_lean tile keeps"):
        detect.detect_bursts_fused(cfg, s, 100)
    with pytest.raises(RuntimeError, match="gfdm_detect_front kernel failed to launch"
                                           ".*the detect_front tile keeps"):
        detect.detect_front_fused(cfg, s, 100)
    assert detect.LAUNCHES == before


# ---------------------------------------------------------------------------
# receiver and link options, the CDD transmitter and the superseded receivers
# ---------------------------------------------------------------------------
RX_OPTIONS = {
    "mmse": dict(equalizer="mmse"),
    "mmse_cnr": dict(equalizer="mmse_cnr"),
    "mmse_cnr-qam16": dict(equalizer="mmse_cnr", constellation="qam16"),
    "mmse-qam64": dict(equalizer="mmse", constellation="qam64"),
    "phase": dict(phase_compensation=True),
    "qpsk_amp": dict(qpsk_amp=0.6),
}


def _qam_payload(cfg, name, seed, dev):
    """(B, 2, n_data) payload of the constellation's points (numpy seed)."""
    from gfdm_tpu_torch.ops.rx import constellation_points

    pts = constellation_points(name)
    idx = np.random.default_rng(seed).integers(0, pts.size, (B, cfg.n_data_symbols))
    sym = pts[idx]
    return torch.from_numpy(np.stack([sym.real, sym.imag], 1).astype(np.float32)).to(dev)


@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
@pytest.mark.parametrize("case", sorted(RX_OPTIONS))
def test_rx_kernel_options_match_plain(case, ic_mode):
    """Each receiver option on noisy bursts, against the plain version summed
    in float64 as the kernels sum their float32-stack products; bursts whose
    IC decisions differ between kernel and plain version (a decision within
    float rounding of a level boundary) are counted and left out, at most
    one here."""
    dev = _cuda()
    cfg = CONFIGS["canonical"]
    kw = RX_OPTIONS[case]
    name = kw.get("constellation", "qpsk")
    data = _qam_payload(cfg, name, 71, dev)
    bursts = fused.tx_frame_fused(cfg, data)
    gen = torch.Generator(dev).manual_seed(2)
    bursts = bursts + 0.01 * torch.randn(bursts.shape, device=dev, generator=gen)
    before = fused.LAUNCHES["rx"]
    chan, sym, met = fused.rx_receiver_fused(cfg, bursts, ic_mode=ic_mode, **kw)
    assert fused.LAUNCHES["rx"] == before + fused.rx_launches(2, kw.get("phase_compensation",
                                                                       False))
    rchan, rsym, rmet = fused._rx_receiver_plain(cfg, bursts.reshape(B, -1), 2, ic_mode,
                                                 gdot=fused._gdot64, **kw)
    assert _max_err(chan, rchan) < 2e-4
    err = (sym.reshape(B, -1) - rsym).abs().amax(dim=1)
    assert int((err >= 5e-4).sum()) <= 1
    assert float(err[err < 5e-4].max()) < 5e-4


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["qam16", "qam64"])
def test_link_kernel_options_match_plain(name, dtype_name):
    """The link at qam16 / qam64 decisions, float32 or bf16 stacks. A burst
    whose last IC decisions (made after one iteration) differ between kernel
    and plain version is left out: qam64's clean loopback has decisions near
    the level boundaries (at most 1% of the bursts; 2% with bf16). With bf16
    the plain version sums in float64 (sum64), as the kernels' Tx and
    estimate stages do: float32 sums in another order would leave some
    activations on the other side of a bf16 rounding boundary."""
    dev = _cuda()
    cfg = CONFIGS["canonical"]
    data = _qam_payload(cfg, name, 81, dev)
    kw = dict(constellation=name, dtype_name=dtype_name, ic_mode="matmul")
    pkw = dict(dtype_name=dtype_name, sum64=dtype_name == "bfloat16")
    before = fused.LAUNCHES["link"]
    d_hat, _snr, evm = fused.link_single_fused(cfg, data, **kw)
    assert fused.LAUNCHES["link"] == before + fused.link_launches("matmul", 2)
    flat = data.reshape(B, -1)
    ref, _met = fused._link_single_plain(cfg, flat, 2, "matmul", name, **pkw)
    k = fused.link_single_fused(cfg, data, ic_iterations=1, **kw)[0].reshape(B, -1)
    p = fused._link_single_plain(cfg, flat, 1, "matmul", name, **pkw)[0]
    flipped = (fused._ic_level(k, name) != fused._ic_level(p, name)).any(dim=1)
    assert int(flipped.sum()) <= (0.01 if dtype_name == "float32" else 0.02) * B
    tol = 1e-4 if dtype_name == "float32" else 1e-2
    keep = ~flipped
    assert float((d_hat.reshape(B, -1)[keep] - ref[keep]).abs().max()) < tol
    ref_evm = float(((ref - data.reshape(B, -1)) ** 2).sum() / (data**2).sum()) ** 0.5
    assert abs(float(evm) - ref_evm) < 1e-4


@pytest.mark.parametrize("phase", [False, True])
@pytest.mark.parametrize("ic_iterations", [0, 1, 3])
@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
def test_rx_kernel_ic_iterations_match_plain(ic_mode, ic_iterations, phase):
    """The receiver's plan at 0, 1 and 3 IC iterations, with and without the
    phase stage (which runs only before an IC iteration), on noisy bursts
    whose data section is rotated by 0.1 rad, against the plain version
    summed in float64; at most one burst whose decisions differ at a level
    boundary is left out."""
    dev = _cuda()
    cfg = CONFIGS["canonical"]
    bursts = fused.tx_frame_fused(cfg, _payload(cfg, 72, dev))
    c, s, p = float(np.cos(0.1)), float(np.sin(0.1)), cfg.preamble_len
    re, im = bursts[:, 0, p:].clone(), bursts[:, 1, p:].clone()
    bursts[:, 0, p:], bursts[:, 1, p:] = c * re - s * im, s * re + c * im
    gen = torch.Generator(dev).manual_seed(4)
    bursts = bursts + 0.01 * torch.randn(bursts.shape, device=dev, generator=gen)
    kw = dict(ic_mode=ic_mode, phase_compensation=phase)
    before = fused.LAUNCHES["rx"]
    chan, sym, met = fused.rx_receiver_fused(cfg, bursts, ic_iterations=ic_iterations, **kw)
    assert fused.LAUNCHES["rx"] == before + fused.rx_launches(ic_iterations, phase)
    assert fused.rx_launches(ic_iterations, phase) == 4 + ic_iterations + (
        phase and ic_iterations > 0)
    rchan, rsym, rmet = fused._rx_receiver_plain(cfg, bursts.reshape(B, -1), ic_iterations,
                                                 gdot=fused._gdot64, **kw)
    assert _max_err(chan, rchan) < 2e-4
    assert float(((met - rmet).abs() / (rmet.abs() + 1e-12))[:, 0].max()) < 1e-3
    err = (sym.reshape(B, -1) - rsym).abs().amax(dim=1)
    assert int((err >= 5e-4).sum()) <= 1
    assert float(err[err < 5e-4].max()) < 5e-4


@pytest.mark.parametrize("equalizer", ["zf", "mmse", "mmse_cnr"])
def test_rx_stages_match_plain_stages(equalizer):
    """Each product stage of the receiver (preamble power, channel, Y with
    the equalizer's weight, D0) against the plain stage summed in float64
    on the kernel's own inputs: within 1e-5 of the stage's largest
    magnitude."""
    dev = _cuda()
    cfg = CONFIGS["canonical"]
    bursts = fused.tx_frame_fused(cfg, _payload(cfg, 73, dev))
    gen = torch.Generator(dev).manual_seed(5)
    bursts = (bursts + 0.05 * torch.randn(bursts.shape, device=dev, generator=gen))
    errs = fused._rx_stage_errors(cfg, bursts.reshape(B, -1), equalizer)
    assert sorted(errs) == ["chan", "demod", "est_zf", "pre_dft"]
    for stage, e in errs.items():
        assert float(e.max()) < 1e-5, (stage, float(e.max()))


def _link_vs_plain(cfg, data, ic_mode, dtype_name="float32", name="qpsk", ic_iterations=2):
    """The link kernels against the plain version: launches, then the data
    of the bursts whose last IC decisions agree (1e-4 float32, 1e-2 bf16;
    at most max(1, 1% / 2%) of the bursts differ there, each a decision at
    a level boundary), and the EVM within 1e-4. With bf16 stacks the plain
    version sums in float64 (sum64), as the kernels' Tx and estimate stages
    do, and each product stage is held to the plain stage on the kernel's
    own inputs (1e-5 of its largest magnitude)."""
    nb = data.shape[0]
    kw = dict(constellation=name, dtype_name=dtype_name, ic_mode=ic_mode)
    before = fused.LAUNCHES["link"]
    d_hat, snr, evm = fused.link_single_fused(cfg, data, ic_iterations=ic_iterations, **kw)
    assert fused.LAUNCHES["link"] == before + fused.link_launches(ic_mode, ic_iterations)
    assert d_hat.shape == data.shape and snr.shape == (nb,)
    flat = data.reshape(nb, -1)
    bf16 = dtype_name == "bfloat16"
    pkw = dict(dtype_name=dtype_name, sum64=bf16)
    ref, _met = fused._link_single_plain(cfg, flat, ic_iterations, ic_mode, name, **pkw)
    keep = torch.ones(nb, dtype=torch.bool, device=data.device)
    if ic_iterations > 0:
        it = ic_iterations - 1
        k = fused.link_single_fused(cfg, data, ic_iterations=it, **kw)[0].reshape(nb, -1)
        p = fused._link_single_plain(cfg, flat, it, ic_mode, name, **pkw)[0]
        keep = ~(fused._ic_level(k, name) != fused._ic_level(p, name)).any(dim=1)
    err = (d_hat.reshape(nb, -1) - ref).abs().amax(dim=1)
    if bf16:
        for stage, e in fused._link_stage_errors(cfg, flat, dtype_name).items():
            assert float(e.max()) < 1e-5, (stage, float(e.max()))
    share = 0.02 if bf16 else 0.01
    assert int((~keep).sum()) <= max(1.0, share * nb)
    assert float(err[keep].max()) < (1e-2 if bf16 else 1e-4), float(err[keep].max())
    ref_evm = float(((ref - flat) ** 2).sum() / (flat**2).sum()) ** 0.5
    assert abs(float(evm) - ref_evm) < 1e-4
    return float(evm)


@pytest.mark.parametrize("name", ["qam16", "qam64"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
@pytest.mark.parametrize("batch", [80, 130, 4099])
def test_link_kernel_ragged_batches_match_plain(batch, ic_mode, dtype_name, name):
    """Batches that are not a multiple of the 128-burst tile (80: one partial
    tile; 130; 4,099): the rows past the batch are zero-filled and never
    written."""
    dev = _cuda()
    cfg = CONFIGS["canonical"]
    from gfdm_tpu_torch.ops.rx import constellation_points

    pts = constellation_points(name)
    idx = np.random.default_rng(batch).integers(0, pts.size, (batch, cfg.n_data_symbols))
    sym = np.stack([pts[idx].real, pts[idx].imag], 1).astype(np.float32)
    _link_vs_plain(cfg, torch.from_numpy(sym).to(dev), ic_mode, dtype_name, name)


@pytest.mark.parametrize("ic_iterations", [0, 1, 2])
@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
def test_link_kernel_ic_iterations_match_plain(ic_mode, ic_iterations):
    """0 iterations: the demod stage writes the output (EVM at the MF
    floor, ~0.203); 1 and 2: the IC stages ping-pong their decisions and
    the last one demaps."""
    dev = _cuda()
    cfg = CONFIGS["canonical"]
    evm = _link_vs_plain(cfg, _payload(cfg, 82, dev), ic_mode, ic_iterations=ic_iterations)
    assert 0.0 < evm < (0.025 if ic_iterations else 0.25)


@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
def test_link_kernel_at_k512_matches_plain(ic_mode):
    """K = 512 (N = 4608), the largest config the link takes; 130 bursts."""
    from gfdm_tpu_torch.entry import large_k_config

    dev = _cuda()
    cfg = large_k_config(512)
    data = torch.from_numpy(planar_payload(cfg, 130, 92)).to(dev)
    evm = _link_vs_plain(cfg, data, ic_mode)
    assert 0.0 < evm < 0.025


def test_link_bf16_rounded_stages_are_the_float64_sums():
    """With bf16 stacks the Tx stage's F and the estimate stage's Y, which
    the next stages round to bf16, are the plain stages summed in float64
    (_gdot64) on the kernel's own inputs, rounded once: they round to bf16
    alike, but for ties of float64 sums (at most 1e-5 of the elements)."""
    dev = _cuda()
    cfg = CONFIGS["canonical"]
    data = _payload(cfg, 83, dev).reshape(B, -1)
    bufs = {}
    fused._link_single_cuda(cfg, data, fused._rx_options(0, "matmul"), "bfloat16", buffers=bufs)
    n, nd, half, cp = cfg.block_len, cfg.n_data_symbols, 2 * cfg.subcarriers, cfg.cp_len
    k, st = fused._kernel_consts(cfg, dev), fused._stacks(cfg, dev, "bfloat16")

    def prod(x, g, n_in):
        return torch.cat(fused._gdot64(x[:, :n_in], x[:, n_in:], g, n_in), 1)

    f = prod(data, st["T_G"], nd) * k["win"][cp : cp + n].repeat(2)
    chan, x = prod(bufs["pre"], st["E_G"], half), prod(bufs["f"], st["F_G"], n)
    y = torch.cat(fused._zf(x[:, :n], x[:, n:], chan[:, :n], chan[:, n:])[:2], 1)
    for got, want in ((bufs["f"], f), (bufs["y"], y)):
        flips = (got.bfloat16() != want.bfloat16()).float().mean()
        assert float(flips) <= 1e-5
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_tf32_split_kernel_matches_emulation():
    """The kernels' operand split (cvt.rna) equals the CPU emulation bit for
    bit, and hi + lo recovers x to 2^-22 relative (float64)."""
    from tf32_emulation import tf32_split

    dev = _cuda()
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(1 << 16) * 10.0 ** rng.uniform(-30, 30, 1 << 16)).astype(np.float32)
    xt = torch.from_numpy(x)
    hi, lo = fused._tf32_split_cuda(xt.to(dev))
    eh, el = tf32_split(xt)
    assert torch.equal(hi.cpu(), eh) and torch.equal(lo.cpu(), el)
    x64 = xt.double()
    rel = ((hi.cpu().double() + lo.cpu().double() - x64).abs() / x64.abs()).max()
    assert float(rel) <= 2.0**-22


@pytest.mark.parametrize("name,shifts,batch", _tx_cases(((0, 2),) + TX_SHIFTS))
def test_tx_cdd_kernel_matches_plain(name, shifts, batch):
    dev = _cuda()
    cfg = TX_CONFIGS[name].replace(cyclic_shifts=shifts)
    data = _tx_payload(cfg, batch, 61, dev)
    before = dict(fused.LAUNCHES)
    got = fused.tx_cdd_fused(cfg, data)
    assert fused.LAUNCHES["tx_cdd"] == before["tx_cdd"] + 1
    assert fused.LAUNCHES["tx"] == before["tx"]
    ref = fused._tx_cdd_plain(cfg, data.reshape(batch, -1))
    assert got.shape == (batch, len(shifts), 2, cfg.frame_len)
    err = _max_err(got, ref)
    print(f"tx_cdd[{name},B={batch},shifts={shifts}] max_abs={err:.3e} "
          f"bit_equal={err == 0.0}")
    assert err < 2e-5


# the superseded receivers' configs: N = 160 a ragged column tile; at K =
# 128 and 512 the one-kernel receivers they replaced took 4 and 1 bursts a CTA
VARIANT_CONFIGS = {**CONFIGS, "K128": TX_CONFIGS["K128"], "K512": TX_CONFIGS["K512"]}
VARIANT_CASES = [(key, it) for key in ("rx_core", "rx_ic", "rx_full", "rx_hybrid")
                 for it in ((0,) if key == "rx_core" else (0, 1, 2, 3))]


@pytest.mark.parametrize("key,iterations", VARIANT_CASES)
@pytest.mark.parametrize("name", sorted(VARIANT_CONFIGS))
def test_rx_variant_kernels_match_plain(key, name, iterations):
    dev = _cuda()
    cfg = VARIANT_CONFIGS[name]
    bursts = fused.tx_frame_fused(cfg, _payload(cfg, 91, dev))
    gen = torch.Generator(dev).manual_seed(3)
    bursts = bursts + 0.01 * torch.randn(bursts.shape, device=dev, generator=gen)
    flat = bursts.reshape(B, -1)
    fs, n = cfg.preamble_len + cfg.cp_len, cfg.block_len
    chan = fused._rx_receiver_plain(cfg, flat, 0, "conv")[0]
    frames = bursts[..., fs : fs + n].contiguous()
    before = dict(fused.LAUNCHES)
    if key in ("rx_core", "rx_ic"):
        args = (frames, chan.reshape(B, 2, n))
        ref = fused._rx_variant_plain(key, cfg, frames.reshape(B, -1), chan, iterations,
                                      2.0**-0.5)
    else:
        args = (bursts,)
        ref = fused._rx_variant_plain(key, cfg, flat, None, iterations, 2.0**-0.5)
    fn = getattr(fused, {"rx_hybrid": "rx_receiver_hybrid"}.get(key, key + "_fused"))
    got = fn(cfg, *args) if key == "rx_core" else fn(cfg, *args, ic_iterations=iterations)
    launches = fused.variant_launches(key, iterations)
    assert fused.LAUNCHES[key] == before[key] + launches
    assert sum(fused.LAUNCHES.values()) == sum(before.values()) + launches
    if key == "rx_hybrid":
        assert _max_err(got[0], ref[0]) < 2e-4
        got = got[1]
    assert _max_err(got, ref[1]) < 5e-4


def test_service_option_matrix_on_card():
    """The fused engine at mmse_cnr / qam16 on the card: the receiver kernel
    runs once a step and finds every burst of a 30 dB stream."""
    from gfdm_tpu_torch.entry import service_stream
    from gfdm_tpu_torch.runtime.service import StreamingReceiver

    dev = _cuda()
    cfg = CONFIGS["canonical"]
    stream, counts, _pay = service_stream(cfg, 64, 2048, 30.0, False,
                                          np.random.default_rng(4))
    before = fused.LAUNCHES["rx"]
    rx = StreamingReceiver(cfg, chunk_len=2048, batch_chunks=64, engine="fused",
                           equalizer="mmse_cnr", constellation="qam16")
    assert rx.device.type == "cuda"
    out = rx.step(stream)
    assert fused.LAUNCHES["rx"] == before + fused.rx_launches(2)
    assert out["found"].sum() == counts.sum() == 64


@pytest.mark.parametrize("estimator", ["fused", "fast"])
def test_rx_factored_kernels_take_qpsk_amp(estimator):
    """qpsk_amp reaches the factored kernels' IC taps (the plain version at
    the same amplitude), and moves the symbols."""
    dev = _cuda()
    cfg = CONFIGS["canonical"]
    _data, bursts = _factored_bursts(cfg, dev, 300)
    chan, sym = fused.rx_receiver_factored(cfg, bursts, qpsk_amp=0.6, estimator=estimator)
    rchan, rsym = fused._rx_factored_plain(cfg, bursts, chan if estimator == "fast" else None,
                                           2, 0.6)
    assert _max_err(chan, rchan) < 2e-4
    assert _max_err(sym, rsym) < 5e-4
    _c, sym_q = fused.rx_receiver_factored(cfg, bursts, estimator=estimator)
    assert _max_err(sym, sym_q) > 1e-3


@pytest.mark.parametrize("method", ["dense", "fast"])
def test_planar_link_bf16_on_card(method):
    """dtype_name="bfloat16" of the torch-op link on the card against the
    same function on the CPU (bf16 data limit 1e-2 a burst, EVM 1e-4)."""
    from gfdm_tpu_torch.ops.planar_pipeline import link_step_planar

    dev = _cuda()
    cfg = CONFIGS["canonical"]
    data = _payload(cfg, 310, dev)
    d, _s, e = link_step_planar(cfg, data, method=method, dtype_name="bfloat16")
    d_c, _s, e_c = link_step_planar(cfg, data.cpu(), method=method, dtype_name="bfloat16")
    assert float((d.cpu() - d_c).abs().max()) <= 1e-2
    assert abs(float(e) - float(e_c)) <= 1e-4


CHAIN_LIMITS = {"f32": 1e-5, "bf16": 1e-2}


def _chain_check(chain, variant, x, cw):
    """One chain call on the card against the plain version: launches as
    ``chain._KERNELS`` says, int8 bit for bit, f32 and bf16 within
    max |d| / max |ref| CHAIN_LIMITS. f32 sums each element in order, as
    cuBLAS's SGEMM does at the main path's batch (bit-equal there, phase 10
    of chip_smoke.py), but cuBLAS picks its kernel by shape and may split k
    at other batches: float32 sums in another order, hence 1e-5. bf16: a
    sum on the other side of a bf16 rounding boundary moves one activation
    by a bf16 ulp."""
    before = chain.LAUNCHES[f"chain_{variant}"]
    got = chain.gemm_chain(x, cw)
    torch.cuda.synchronize()
    assert chain.LAUNCHES[f"chain_{variant}"] == before + chain._KERNELS[variant]
    ref = chain._chain_plain(x, cw)
    assert got.shape == ref.shape == (x.shape[0], 1152) and bool(torch.isfinite(got).all())
    if variant == "int8":
        assert torch.equal(got, ref)
    else:
        rel = float((got - ref).abs().max() / ref.abs().max())
        assert rel <= CHAIN_LIMITS[variant], rel


# 128: one row tile, fewer CTAs than SMs; 8,320 = 65 x 128: an odd count of
# 128-row tiles (ragged against any 256-row tile)
@pytest.mark.parametrize("batch", [128, 1024, 8192, 8320])
@pytest.mark.parametrize("variant", ["f32", "bf16", "int8"])
def test_chain_kernel_matches_plain(variant, batch):
    """csrc/chain.cu against its plain version at the link's chain shapes,
    each 128-row group at its own scale (1, 10, 0.01, ...)."""
    from gfdm_tpu_torch.benchmarks.int8_gauss import make_inputs
    from gfdm_tpu_torch.kernels import chain

    dev = _cuda()
    weights, x, _s = make_inputs(batch, 1)
    gains = np.array([1.0, 10.0, 0.01, 3.0], dtype=np.float32)
    x = x * np.repeat(np.resize(gains, batch // 128), 128)[:, None]
    cw = chain.chain_weights_from_numpy(weights, variant).to(dev)
    _chain_check(chain, variant, torch.from_numpy(x).to(dev), cw)


@pytest.mark.parametrize("d_in", [8, 1152])
@pytest.mark.parametrize("variant", ["f32", "bf16", "int8"])
def test_chain_kernel_input_widths(variant, d_in):
    """The first stage at d_in = 8 (one k-slab, mostly zero-filled) and
    1152 (whole slabs), with 1152-wide stages after it."""
    from gfdm_tpu_torch.kernels import chain

    dev = _cuda()
    rng = np.random.default_rng(d_in)
    shapes = [(d_in, 1152), (1152, 1152), (1152, 1152)]
    weights = [rng.standard_normal(s).astype(np.float32) / np.sqrt(s[0]) for s in shapes]
    x = rng.standard_normal((384, d_in)).astype(np.float32)
    cw = chain.chain_weights_from_numpy(weights, variant).to(dev)
    _chain_check(chain, variant, torch.from_numpy(x).to(dev), cw)


# int8 edge groups: a group of zeros (its scale clamps to 1e-20), a group
# whose stage-1 max sits in the last 192-column tile (the cluster's last
# rank), one group (one cluster), 65 groups (an odd count, more groups than
# the clusters the card holds at once, so clusters take several)
CHAIN_INT8_CASES = {"zero_group": 1024, "max_in_last_tile": 384, "one_cluster": 128,
                    "odd_groups": 8320}


@pytest.mark.parametrize("case", list(CHAIN_INT8_CASES))
def test_chain_int8_edge_groups(case):
    """The int8 chain (x's pass, two cluster-epilogue stages, a float32
    stage) against its plain version, bit for bit, on edge groups; the
    per-launch calls give the same bits."""
    from gfdm_tpu_torch.benchmarks.int8_gauss import make_inputs
    from gfdm_tpu_torch.kernels import chain

    dev = _cuda()
    batch = CHAIN_INT8_CASES[case]
    weights, x, _s = make_inputs(batch, 1)
    x = x * np.repeat(np.resize(np.float32([1.0, 10.0, 0.01]), batch // 128), 128)[:, None]
    cw = chain.chain_weights_from_numpy(weights, "int8")
    if case == "zero_group":
        x[128:256] = 0.0
    if case == "max_in_last_tile":  # x along W1's column 1151 (int8 weights, rescaled)
        col = cw.w[0][:, 1151].float().numpy()
        x[256:384] = 1e-3 * x[256:384] + col / np.abs(col).max()
    cw = cw.to(dev)
    xd = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
    _chain_check(chain, "int8", xd, cw)
    ref = chain._chain_plain(xd, cw)
    if case == "max_in_last_tile":
        a1 = chain._int8_stage(xd[256:384], cw.w[0], cw.inv[0])
        assert int(a1.abs().amax(dim=0).argmax()) // 192 == 5
    if case == "zero_group":
        assert not ref[128:256].any()
    ev = []
    got = chain._chain_cuda(xd, cw, events=ev)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert len(ev) == chain._KERNELS["int8"] + 1


def _plant_stale_error(lib):
    """Leave a non-sticky error in the kernel library's own CUDA runtime
    (cudaSetDevice on an ordinal no card has): the error a launcher reads
    back with cudaGetLastError unless it cleared it first."""
    assert lib.gfdm_set_device(999) != 0
    assert lib.gfdm_peek_error() != 0


def _chain_args(chain, cw, x, batch, scratch, gmax):
    return (batch, x.shape[1], x.data_ptr(), *(w.data_ptr() for w in cw.w_t or cw.w),
            *(ctypes.c_float(chain._dequant_const(v)) for v in cw.inv or (0.0,) * 3),
            torch.empty(batch, 1152, device=x.device).data_ptr(), scratch.data_ptr(),
            None if gmax is None else gmax.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)


def test_chain_refusal_leaves_no_error_behind():
    """A call gfdm_chain refuses (a batch that is not a multiple of 128, a
    launch index past the schedule) after an earlier call left an error
    returns its own error and leaves none: the runtime's last error is
    clear after it, and a valid chain right after it, in each mode, runs
    and holds to the plain version."""
    from gfdm_tpu_torch.kernels import chain, cuda_lib

    dev = _cuda()
    rng = np.random.default_rng(4)
    weights = [rng.standard_normal(s).astype(np.float32) / np.sqrt(s[0])
               for s in chain.CHAIN_SHAPES]
    x = torch.from_numpy(rng.standard_normal((256, 936)).astype(np.float32)).to(dev)
    cws = {v: chain.chain_weights_from_numpy(weights, v).to(dev) for v in chain.VARIANTS}
    scratch, gmax = chain._chain_scratch(256, "int8", dev)
    lib = cuda_lib.library()
    for batch, part in ((100, -1), (256, 4), (256, -2)):
        for variant in chain.VARIANTS:
            _plant_stale_error(lib)
            args = _chain_args(chain, cws["int8"], x, batch, scratch, gmax)
            assert lib.gfdm_chain(2, part, *args) == 1  # cudaErrorInvalidValue
            assert lib.gfdm_peek_error() == 0
            _chain_check(chain, variant, x, cws[variant])


def _stale_error_calls(dev):
    """name -> a call through a launcher's wrapper (a refused launch raises)."""
    from gfdm_tpu_torch.kernels import chain

    cfg = GfdmConfig()
    data = _payload(cfg, 90, dev)
    rng = np.random.default_rng(6)
    weights = [rng.standard_normal(s).astype(np.float32) / np.sqrt(s[0])
               for s in chain.CHAIN_SHAPES]
    x = torch.from_numpy(rng.standard_normal((256, 936)).astype(np.float32)).to(dev)
    cws = {v: chain.chain_weights_from_numpy(weights, v).to(dev) for v in chain.VARIANTS}
    from gfdm_tpu_torch.coding import viterbi_decode

    llrs = torch.from_numpy(dyadic_llrs(462, 65, seed=9)[0]).to(dev)
    return {
        "viterbi": lambda: viterbi_decode(llrs, 462),
        "tx": lambda: fused.tx_frame_fused(cfg, data),
        "link": lambda: fused.link_single_fused(cfg, data)[0],
        "tf32_split": lambda: torch.stack(fused._tf32_split_cuda(x)),
        **{f"chain_{v}": (lambda v=v: chain.gemm_chain(x, cws[v])) for v in chain.VARIANTS},
    }


@pytest.mark.parametrize("name", ["tx", "link", "tf32_split", "chain_f32", "chain_bf16",
                                  "chain_int8", "viterbi"])
def test_launchers_clear_a_stale_error(name):
    """Each launcher (csrc/tx.cu, link.cu's stage launches and tf32 split,
    chain.cu, viterbi.cu) reports its own launch only: with an error left in the
    runtime before it, the call runs, gives the bits of a clean call, and
    leaves the runtime's last error clear."""
    from gfdm_tpu_torch.kernels import cuda_lib

    dev = _cuda()
    call = _stale_error_calls(dev)[name]
    lib = cuda_lib.library()
    clean = call()
    torch.cuda.synchronize()
    _plant_stale_error(lib)
    got = call()
    torch.cuda.synchronize()
    assert lib.gfdm_peek_error() == 0
    assert torch.equal(got, clean)


def test_chain_kernel_refuses_other_shapes():
    from gfdm_tpu_torch.kernels import chain

    dev = _cuda()
    rng = np.random.default_rng(1)
    narrow = [rng.standard_normal(s) for s in [(936, 48), (48, 48), (48, 48)]]
    cw = chain.chain_weights_from_numpy(narrow, "f32").to(dev)
    with pytest.raises(ValueError, match="1152-wide"):
        chain.gemm_chain(torch.zeros(128, 936, device=dev), cw)
    with pytest.raises(ValueError, match="multiple of 128"):
        chain.gemm_chain(torch.zeros(100, 936, device=dev), cw)


# the coded modem on the card: the decoder and the soft bits against their
# CPU runs, the transmit service on the Tx kernel, the coded service
VITERBI_MODES = ("auto", "radix", "full", "sm", "windowed")


@pytest.mark.parametrize("mode", VITERBI_MODES)
@pytest.mark.parametrize("n_info", [462, 133])
def test_viterbi_card_matches_cpu(mode, n_info):
    """Every mode bit-equal card against CPU on dyadic LLRs (462: the
    canonical block, radix 16; 133: T = 139, no radix divides it)."""
    from gfdm_tpu_torch.coding import viterbi_decode

    _cuda()
    llrs = dyadic_llrs(n_info, 1027, seed=n_info)[0]
    if mode == "radix" and n_info == 133:
        with pytest.raises(ValueError, match="no radix"):
            viterbi_decode(llrs, n_info, mode)
        return
    card = viterbi_decode(llrs, n_info, mode)  # a NumPy array goes to the card
    assert card.device.type == "cuda" and card.dtype == torch.uint8
    cpu = viterbi_decode(torch.from_numpy(llrs), n_info, mode)
    assert torch.equal(card.cpu(), cpu)


# the Viterbi kernel (csrc/viterbi.cu) against the plain version on the CPU:
# radix 16 at the coded cells' T = 468 and 1,404, radix 8 (T = 471), 4 (470)
# and 2 (139: no radix divides it); dyadic LLRs (ties everywhere) and
# continuous ones (noisy codewords at 1 dB)
VITERBI_T = (468, 1404, 471, 470, 139)


def _viterbi_llrs(kind, T, batch, seed):
    if kind == "dyadic":
        return dyadic_llrs(T - 6, batch, seed)[0]
    return noisy_llrs(batch, T, seed).reshape(batch, 2 * T)


@pytest.mark.parametrize("kind", ["dyadic", "continuous"])
@pytest.mark.parametrize("batch", [1, 65, 4096])
@pytest.mark.parametrize("T", VITERBI_T)
@pytest.mark.parametrize("mode", VITERBI_MODES)
def test_viterbi_kernel_matches_cpu(mode, T, batch, kind):
    """Every mode launches the kernel once on the card, and its bits are
    equal to the plain version's on the CPU."""
    from gfdm_tpu_torch.coding import viterbi_decode
    from gfdm_tpu_torch.kernels import viterbi

    dev = _cuda()
    llrs = torch.from_numpy(_viterbi_llrs(kind, T, batch, seed=T + batch))
    if mode == "radix" and T == 139:
        with pytest.raises(ValueError, match="no radix"):
            viterbi_decode(llrs.to(dev), T - 6, mode)
        return
    before = viterbi.LAUNCHES["viterbi"]
    card = viterbi_decode(llrs.to(dev), T - 6, mode)
    assert viterbi.LAUNCHES["viterbi"] == before + 1
    assert card.device.type == "cuda" and card.dtype == torch.uint8
    assert torch.equal(card.cpu(), viterbi_decode(llrs, T - 6, mode))


# past ~3,200 steps a block's decisions outgrow shared memory and the
# kernel keeps them in a global scratch: T = 3,600 just past that at radix
# 16, and 37,440, the codeword of `rx --fec conv -K 1024 -M 15
# --constellation qam64` (k = 4; "full" runs it one step a step)
@pytest.mark.parametrize("T", [3600, 37440])
@pytest.mark.parametrize("mode", VITERBI_MODES)
def test_viterbi_kernel_decodes_long_codewords(mode, T):
    """Codewords whose decisions the kernel keeps in global memory decode
    in one launch to the CPU's bits, in every mode."""
    from gfdm_tpu_torch.coding import viterbi_decode
    from gfdm_tpu_torch.kernels import viterbi

    dev = _cuda()
    assert viterbi._scratch_bytes(T, 4, dev) > 0 and viterbi._scratch_bytes(T, 1, dev) > 0
    assert viterbi._scratch_bytes(1404, 4, dev) == 0
    llrs = torch.from_numpy(_viterbi_llrs("continuous", T, 3, seed=T))
    before = viterbi.LAUNCHES["viterbi"]
    card = viterbi_decode(llrs.to(dev), T - 6, mode)
    assert viterbi.LAUNCHES["viterbi"] == before + 1
    assert torch.equal(card.cpu(), viterbi_decode(llrs, T - 6, mode))


@pytest.mark.parametrize("mode", ["auto", "full", "windowed"])
def test_viterbi_kernel_matches_cpu_on_nonfinite_llrs(mode):
    """NaN, infinite and huge LLRs: the kernel keeps torch's choices (the
    first NaN, else the first maximum) and gives the CPU's bits."""
    from gfdm_tpu_torch.coding import viterbi_decode

    dev = _cuda()
    llrs = _viterbi_llrs("continuous", 468, 65, seed=5)
    rng = np.random.default_rng(6)
    for value in (np.nan, np.inf, -np.inf, 3e38, -3e38):
        llrs.reshape(-1)[rng.choice(llrs.size, 40, replace=False)] = value
    llrs = torch.from_numpy(llrs)
    assert torch.equal(viterbi_decode(llrs.to(dev), 462, mode).cpu(),
                       viterbi_decode(llrs, 462, mode))


def test_viterbi_on_card_runs_no_torch_op_loop(monkeypatch):
    """A CUDA call never enters the plain version's ACS, pattern sums or
    traceback, in any mode."""
    from gfdm_tpu_torch import coding

    dev = _cuda()
    llrs = torch.from_numpy(dyadic_llrs(462, 65, seed=4)[0])
    want = {mode: coding.viterbi_decode(llrs, 462, mode) for mode in VITERBI_MODES}

    def refuse(*args, **kwargs):
        raise AssertionError("the torch-op decoder ran on a CUDA tensor")

    for name in ("_pattern_sums", "_forward", "_traceback"):
        monkeypatch.setattr(coding, name, refuse)
    for mode in VITERBI_MODES:
        assert torch.equal(coding.viterbi_decode(llrs.to(dev), 462, mode).cpu(), want[mode])


def test_viterbi_kernel_takes_a_view_off_16_bytes():
    """LLRs one float into their storage (the kernel reads 16-byte
    vectors): the wrapper decodes a copy, with the CPU's bits."""
    from gfdm_tpu_torch.kernels import viterbi

    dev = _cuda()
    x = torch.from_numpy(_viterbi_llrs("continuous", 468, 65, seed=8)).reshape(65, 468, 2)
    flat = torch.empty(x.numel() + 1, device=dev)
    flat[1:] = x.reshape(-1).to(dev)
    lp = flat[1:].view(65, 468, 2)
    assert lp.data_ptr() % 16
    assert torch.equal(viterbi.decode(lp, 4).cpu(), viterbi.decode(x, 4))


def test_viterbi_kernel_refuses_other_inputs():
    """The wrapper raises ValueError on CUDA LLRs that are not float32,
    contiguous, (B, T, 2) with k dividing T, or options of another shape."""
    from gfdm_tpu_torch.kernels import viterbi

    dev = _cuda()
    lp = torch.zeros(8, 468, 2, device=dev)
    for bad, k, kw in ((lp.double(), 4, {}), (lp.transpose(0, 1), 4, {}),
                       (lp[..., :1].contiguous(), 4, {}), (lp.reshape(8, 936), 4, {}),
                       (lp[:, :466].contiguous(), 4, {}), (lp, 5, {}),
                       (lp, 4, {"pm0": torch.zeros(8, 32, device=dev)}),
                       (lp, 4, {"from_argmax": torch.zeros(8, device=dev)})):
        with pytest.raises(ValueError):
            viterbi.decode(bad, k, **kw)


@pytest.mark.parametrize("name", ["qpsk", "qam16", "qam64"])
def test_softbits_card_matches_cpu(name):
    from gfdm_tpu_torch.ops import softbits
    from gfdm_tpu_torch.ops.rx import constellation_points

    dev = _cuda()
    rng = np.random.default_rng(3)
    pl = rng.standard_normal((257, 2, 468)).astype(np.float32)
    nv = rng.uniform(0.05, 0.5, (257, 1)).astype(np.float32)
    pts = constellation_points(name)
    s = torch.from_numpy(pl[:, 0] + 1j * pl[:, 1]).to(torch.complex64)
    for fn, x in ((softbits.maxlog_llrs_planar, torch.from_numpy(pl)),
                  (softbits.maxlog_llrs, s)):
        cpu = fn(x, pts, torch.from_numpy(nv))
        card = fn(x.to(dev), pts, torch.from_numpy(nv).to(dev))
        assert card.device.type == "cuda"
        tol = 1e-5 * float(cpu.abs().max())
        assert float(((card.cpu() - cpu).abs() - 1e-5 * cpu.abs()).max()) <= tol
    if name == "qpsk":
        cpu = softbits.qpsk_llrs_planar(torch.from_numpy(pl), torch.from_numpy(nv[:, 0]))
        card = softbits.qpsk_llrs_planar(torch.from_numpy(pl).to(dev),
                                         torch.from_numpy(nv[:, 0]).to(dev))
        torch.testing.assert_close(card.cpu(), cpu, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("batch", [1, 65, 4096])
def test_transmitter_step_runs_the_tx_kernel(batch):
    """StreamingTransmitter on the card (its default device): one Tx-kernel
    launch a step, bit-equal to the plain Tx times the scale."""
    from gfdm_tpu_torch.runtime.transmit_service import StreamingTransmitter

    dev = _cuda()
    cfg = GfdmConfig(cyclic_shifts=(0, 4))
    pls = planar_payload(cfg, batch, seed=5)
    tx = StreamingTransmitter(cfg, scale=0.5, cyclic_shift_index=1)
    assert tx.device.type == "cuda"
    before = fused.LAUNCHES["tx"]
    got = tx.step(pls)
    assert fused.LAUNCHES["tx"] == before + 1
    flat = torch.from_numpy(pls).to(dev).reshape(batch, -1)
    ref = (fused._tx_frame_plain(cfg, flat, 1) * 0.5).reshape(batch, 2, cfg.frame_len)
    err = float(np.abs(got - ref.cpu().numpy()).max())
    print(f"tx_service[B={batch}] max_abs={err:.3e} bit_equal={err == 0.0}")
    assert err < 2e-5
    if batch == 4096:
        assert err == 0.0


def test_coded_service_on_card():
    """StreamingReceiver(fused, fec="conv") on the card: every found slot's
    payload CRC-clean and equal to what was sent, and its bits equal to a
    CPU decode of the LLRs the card computed."""
    from gfdm_tpu_torch.cli import burst_capacity_bytes, payload_to_symbols
    from gfdm_tpu_torch.coding import viterbi_decode
    from gfdm_tpu_torch.ops import softbits
    from gfdm_tpu_torch.runtime.service import StreamingReceiver
    from gfdm_tpu_torch.utils.framing import check_crc32, pack_bits

    dev = _cuda()
    cfg, n, chunk = GfdmConfig(), 64, 2048
    cap = burst_capacity_bytes(cfg, 2, "conv")
    rng = np.random.default_rng(12)
    payload = bytes(rng.integers(0, 256, n * cap, dtype=np.uint8))
    syms, nb = payload_to_symbols(cfg, payload, fec="conv")
    bursts = fused.tx_frame_fused(cfg, torch.from_numpy(
        np.stack([syms.real, syms.imag], axis=1).astype(np.float32)).to(dev)).cpu().numpy()
    sig = float(np.mean(np.sum(bursts**2, axis=1)))
    halo = cfg.frame_len + cfg.cp_len
    chunks = (np.sqrt(sig / 10 / 2) * rng.standard_normal((n, 2, chunk + halo))
              ).astype(np.float32)
    offs = rng.integers(0, chunk - cfg.frame_len, n)
    for i in range(n):
        chunks[i, :, offs[i] : offs[i] + cfg.frame_len] += bursts[i]
    rx = StreamingReceiver(cfg, chunk_len=chunk, batch_chunks=n, engine="fused",
                           fec="conv")
    out = rx._step(torch.from_numpy(chunks).to(dev))
    found = out["found"].cpu().numpy()
    assert found.all()
    bits = out["bits"].cpu().numpy()
    got = b"".join(check_crc32(pack_bits(b[: (cap + 4) * 8]))[1] for b in bits)
    assert all(check_crc32(pack_bits(b[: (cap + 4) * 8]))[0] for b in bits)
    assert got == payload
    nv = 1.0 / torch.clamp_min(out["snr_lin"], 1e-6)
    llrs = softbits.maxlog_llrs_planar(out["data"], rx._fec_points, nv[:, None])
    llrs = llrs.reshape(n, -1)[:, rx._fec_inv]
    np.testing.assert_array_equal(viterbi_decode(llrs.cpu(), rx.fec_info_bits).numpy(),
                                  bits)


@pytest.mark.parametrize("fft_len", [None, 1024])
def test_legacy_modulator_card_matches_cpu(fft_len, monkeypatch):
    """ops.legacy.modulate_oversampled on the card against the CPU, with
    TF32 turned on around the call: the product keeps full float32."""
    from gfdm_tpu_torch.ops import legacy

    dev = _cuda()
    cfg = GfdmConfig()
    rng = np.random.default_rng(31)
    grid = ((rng.standard_normal((4096, cfg.block_len))
             + 1j * rng.standard_normal((4096, cfg.block_len))) / 2**0.5).astype(np.complex64)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    got = legacy.modulate_oversampled(cfg, grid, fft_len)
    assert got.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32
    ref = legacy.modulate_oversampled(cfg, grid, fft_len, device="cpu")
    # relative to the largest output (~29: the legacy taps are not
    # normalized); TF32 would leave ~1e-3
    scale = float(ref.abs().max())
    err = float((got.cpu() - ref).abs().max()) / scale
    print(f"legacy[fft_len={fft_len}] max_abs/max|y|={err:.3e} max|y|={scale:.2f}")
    assert err < 2e-5


def test_block_flowgraph_card_matches_cpu():
    """The receive flowgraph of blocks (sync + extraction, estimator,
    receiver, demapper) on the card against the same blocks on the CPU."""
    from gfdm_tpu_torch import blocks

    dev = _cuda()
    cfg = GfdmConfig()
    n = 512
    rng = np.random.default_rng(32)
    data = ((rng.integers(0, 2, (n, cfg.n_data_symbols)) * 2 - 1)
            + 1j * (rng.integers(0, 2, (n, cfg.n_data_symbols)) * 2 - 1)) / 2**0.5
    noise = 0.005 * (rng.standard_normal((n, 2048)) + 1j * rng.standard_normal((n, 2048)))
    out = {}
    for key, where in (("card", dev), ("cpu", "cpu")):
        b = blocks.transmitter_cc(cfg, device=where)(
            blocks.resource_demapper_cc(cfg, device=where)(
                blocks.resource_mapper_cc(cfg, device=where)(data)))[:, 0]
        s = torch.zeros((n, 2048), dtype=b.dtype, device=b.device)
        s[:, 300 : 300 + cfg.frame_len] = b
        s = s + torch.from_numpy(noise.astype(np.complex64)).to(b.device)
        ext = blocks.extract_burst_cc(cfg, device=where)
        det = ext.sync(s)
        bursts = ext(s, det)
        chan, tags = blocks.channel_estimator_cc(cfg, device=where)(
            bursts[:, cfg.cp_len : cfg.cp_len + 2 * cfg.subcarriers])
        frames = bursts[:, cfg.preamble_len + cfg.cp_len :][:, : cfg.block_len]
        syms = blocks.advanced_receiver_sb_cc(cfg, device=where)(frames, channel=chan)
        out[key] = (det["start"].cpu(), blocks.resource_demapper_cc(cfg, device=where)(
            syms).cpu(), tags["snr_lin"].cpu())
        assert out[key][1].device.type == "cpu" and syms.device.type == torch.device(
            where).type
    assert torch.equal(out["card"][0], out["cpu"][0])
    err = float((out["card"][1] - out["cpu"][1]).abs().max())
    snr = float((out["card"][2] / out["cpu"][2] - 1).abs().max())
    print(f"block flowgraph B={n} data max_abs={err:.3e} snr_rel={snr:.3e}")
    assert err < 5e-4 and snr < 1e-3
    d = out["card"][1].numpy()
    assert np.array_equal(np.sign(d.real), np.sign(data.real))


# ---------------------------------------------------------------------------
# the parallel layer: the virtual card mesh, the sp service, the stage timer
# ---------------------------------------------------------------------------
def test_stage_timer_matches_cuda_events():
    """StageTimer.stage and timeit time card work with CUDA events on the
    current stream: within 5% of events recorded around the same work."""
    from gfdm_tpu_torch.utils.profiling import StageTimer

    dev = _cuda()
    a = torch.randn(4096, 4096, device=dev)

    def work():
        x = a
        for _ in range(8):
            x = x @ a / 64.0
        return x

    work()
    torch.cuda.synchronize()
    for _ in range(3):
        timer = StageTimer()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        with timer.stage("mm") as s:
            s.value = work()
        stop.record()
        stop.synchronize()
        events = start.elapsed_time(stop) / 1e3
        assert "mm" not in timer.unfenced
        assert abs(timer.times["mm"] - events) <= 0.05 * events
    per = timer.timeit("mm_timeit", work, iters=5)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        work()
    stop.record()
    stop.synchronize()
    ref = start.elapsed_time(stop) / 1e3 / 5
    print(f"StageTimer {per * 1e3:.3f} ms a call, CUDA events {ref * 1e3:.3f} ms")
    assert abs(per - ref) <= 0.05 * ref


@pytest.mark.parametrize("impl", ["twostage", "pallas2"])
def test_sp_service_on_the_card_matches_the_cpu(impl, monkeypatch):
    """StreamingReceiver(sp_shards=2) on a virtual mesh of the card twice
    against the same service on the CPU: found and starts equal, data of
    found slots within the receiver's tolerance; one receiver call a step."""
    from gfdm_tpu_torch.entry import service_stream
    from gfdm_tpu_torch.ops import planar_pipeline as pp
    from gfdm_tpu_torch.parallel import make_mesh
    from gfdm_tpu_torch.runtime.service import StreamingReceiver

    dev = _cuda()
    monkeypatch.setattr(pp, "DETECT_IMPL", impl)
    cfg = GfdmConfig()
    chunks, _counts, _ = service_stream(cfg, 256, 2048, 20.0, False, np.random.default_rng(3))
    out = {}
    for where in (dev, torch.device("cpu")):
        rx = StreamingReceiver(cfg, batch_chunks=256, engine="fused", sp_shards=2,
                               mesh=make_mesh([where] * 2, dp=1, sp=2))
        before = fused.LAUNCHES["rx"]
        out[where.type] = rx.step(chunks)
        launched = fused.LAUNCHES["rx"] - before
        assert launched == (fused.rx_launches(2) if where.type == "cuda" else 0)
    card, cpu = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(card["found"], cpu["found"])
    np.testing.assert_array_equal(card["start"], cpu["start"])
    f = cpu["found"]
    # every burst found but one whose preamble CP straddles the sub-chunk
    # boundary (the JAX package's sp service misses it too)
    starts = card["start"].reshape(-1, 2) + np.array([0, 1024])
    lost = ~f.reshape(-1, 2).any(axis=1)
    assert lost.sum() <= 2
    assert (np.abs(starts[lost] - 1024) <= cfg.subcarriers).all()
    np.testing.assert_allclose(card["data"][f], cpu["data"][f], atol=1e-4)


@pytest.mark.parametrize("planar", [False, True], ids=["complex", "planar"])
def test_sharded_detection_across_the_card_and_the_host(planar):
    """detect_bursts_sharded on a mesh alternating the card and the CPU (a
    head crossing between them at every shard) against the all-CPU mesh."""
    from gfdm_tpu_torch.ops.tx import transmit
    from gfdm_tpu_torch.parallel import detect_bursts_sharded, make_mesh
    from gfdm_tpu_torch.ref import utils

    dev = _cuda()
    cfg = GfdmConfig()
    data = np.stack([utils.random_qpsk(cfg.n_data_symbols, seed=31 + i)
                     for i in range(2)]).astype(np.complex64)
    rng = np.random.default_rng(4)
    stream = (0.01 * (rng.standard_normal((2, 8192)) + 1j * rng.standard_normal((2, 8192)))
              ).astype(np.complex64)
    stream[:, 4096 + 150 : 4096 + 150 + cfg.frame_len] += transmit(
        cfg, data, device="cpu")[:, 0].numpy()
    if planar:
        stream = np.stack([stream.real, stream.imag], 1).astype(np.float32)
    x = torch.from_numpy(stream)
    mixed = make_mesh([dev, "cpu"] * 4, dp=2, sp=4)
    host = make_mesh(["cpu"] * 8, dp=2, sp=4)
    det_m, b_m = detect_bursts_sharded(cfg, mixed, x, halo=cfg.frame_len + 64, planar=planar)
    det_h, b_h = detect_bursts_sharded(cfg, host, x, halo=cfg.frame_len + 64, planar=planar)
    assert b_m.device.type == "cpu"
    for key in ("start", "owned", "found"):
        assert torch.equal(det_m[key], det_h[key]), key
    assert det_h["found"].sum() == 2  # the owner of each row
    f = det_h["found"]
    assert float((det_m["cfo"] - det_h["cfo"])[f].abs().max()) <= 1e-6
    assert float((b_m - b_h)[f].abs().max()) <= 1e-5 * float(b_h.abs().max())
