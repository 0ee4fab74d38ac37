"""Each CUDA kernel of gfdm_tpu_torch against its plain torch version, on the card.

Imports torch and the port only, so it runs on a machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py tests/test_torch_entry.py

Without a CUDA device every test skips. chip_smoke.py runs the same
comparisons at the main path's full batch.
"""
import pytest
import torch

from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import planar_payload
from gfdm_tpu_torch.kernels import fused

pytestmark = pytest.mark.gpu

B = 1027  # not a multiple of the 8-burst tile: the last tile is masked
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


@pytest.mark.parametrize("shift_index", [0, 1])
def test_tx_kernel_matches_plain(shift_index):
    dev = _cuda()
    cfg = GfdmConfig(cyclic_shifts=(0, 4))
    data = _payload(cfg, 60, dev)
    before = fused.LAUNCHES["tx"]
    got = fused.tx_frame_fused(cfg, data, shift_index=shift_index)
    assert fused.LAUNCHES["tx"] == before + 1
    ref = fused._tx_frame_plain(cfg, data.reshape(B, -1), shift_index)
    assert _max_err(got, ref) < 2e-5


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
def test_rx_kernel_matches_plain(ic_mode, name):
    dev = _cuda()
    cfg = CONFIGS[name]
    bursts = fused.tx_frame_fused(cfg, _payload(cfg, 70, dev))
    gen = torch.Generator(dev).manual_seed(0)
    bursts = bursts + 0.05 * torch.randn(bursts.shape, device=dev, generator=gen)
    before = fused.LAUNCHES["rx"]
    chan, sym, met = fused.rx_receiver_fused(cfg, bursts, ic_mode=ic_mode)
    assert fused.LAUNCHES["rx"] == before + 1
    rchan, rsym, rmet = fused._rx_receiver_plain(cfg, bursts.reshape(B, -1), 2, ic_mode)
    assert _max_err(chan, rchan) < 2e-4
    assert _max_err(sym, rsym) < 5e-4
    rel = ((met[:, 0] - rmet[:, 0]).abs() / rmet[:, 0].abs()).max()
    assert float(rel) < 1e-3


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
def test_link_kernel_matches_plain(ic_mode, name):
    dev = _cuda()
    cfg = CONFIGS[name]
    data = _payload(cfg, 80, dev)
    before = fused.LAUNCHES["link"]
    d_hat, _snr, evm = fused.link_single_fused(cfg, data, ic_mode=ic_mode)
    assert fused.LAUNCHES["link"] == before + 1
    ref, _met = fused._link_single_plain(cfg, data.reshape(B, -1), 2, ic_mode)
    assert _max_err(d_hat, ref) < 1e-4
    assert 0.0 < float(evm) < 0.025


def test_receiver_tile_too_large_for_shared_memory_raises():
    """N = 1152 (K=128) needs ~310 KB of shared memory for an 8-burst tile:
    the launch is refused and the wrapper raises; the Tx kernel still runs."""
    dev = _cuda()
    cfg = GfdmConfig(subcarriers=128, active_subcarriers=100, timeslots=9,
                     cp_len=32, cs_len=16)
    data = _payload(cfg, 90, dev)
    bursts = fused.tx_frame_fused(cfg, data)
    assert _max_err(bursts, fused._tx_frame_plain(cfg, data.reshape(B, -1), 0)) < 3e-5
    before = dict(fused.LAUNCHES)
    with pytest.raises(RuntimeError, match="gfdm_rx kernel failed to launch"):
        fused.rx_receiver_fused(cfg, bursts)
    with pytest.raises(RuntimeError, match="gfdm_link kernel failed to launch"):
        fused.link_single_fused(cfg, data)
    assert fused.LAUNCHES["rx"] == before["rx"]
    assert fused.LAUNCHES["link"] == before["link"]


# ---------------------------------------------------------------------------
# detection kernels and the streaming service
# ---------------------------------------------------------------------------
N_CHUNKS = 37  # ragged: not a multiple of anything the kernels tile by
TRACE_TOL = dict(atol=3e-5, rtol=3e-3)  # the JAX package's Pallas limits
PEAK_TOL = dict(atol=1e-6, rtol=1e-4)


def _chunks(cfg, dev, trim=0):
    import numpy as np

    from gfdm_tpu_torch.entry import service_stream

    stream, _counts, _pay = service_stream(cfg, N_CHUNKS, 2048, 20.0, False,
                                           np.random.default_rng(7))
    stream = stream[..., : stream.shape[-1] - trim]
    return torch.from_numpy(np.ascontiguousarray(stream)).to(dev)


def _close(a, b, atol, rtol):
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("trim", [0, 5])
def test_detect_front_kernel_matches_plain(name, trim):
    from gfdm_tpu_torch.kernels import detect

    dev = _cuda()
    cfg = CONFIGS[name]
    s = _chunks(cfg, dev, trim)
    before = detect.LAUNCHES["detect_front"]
    got = detect.detect_front_fused(cfg, s, 2048)
    assert detect.LAUNCHES["detect_front"] == before + 1
    n_valid = min(s.shape[-1] - 2 * cfg.subcarriers, 2048)
    ref = detect._detect_front_plain(cfg, s, n_valid)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _close(g, r, **TRACE_TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("trim", [0, 5])
def test_detect_lean_kernel_matches_plain(name, trim):
    from gfdm_tpu_torch.kernels import detect

    dev = _cuda()
    cfg = CONFIGS[name]
    s = _chunks(cfg, dev, trim)
    before = detect.LAUNCHES["detect_lean"]
    got = detect.detect_bursts_fused(cfg, s, 2048)
    assert detect.LAUNCHES["detect_lean"] == before + 1
    n_valid = min(s.shape[-1] - 2 * cfg.subcarriers, 2048)
    gated, ic = detect._detect_lean_plain(cfg, s, n_valid)
    g2, ic2 = detect._detect_lean_cuda(cfg, s, n_valid)
    assert _close(g2, gated, **TRACE_TOL) and _close(ic2, ic, **TRACE_TOL)
    # the plain epilogue on the plain traces: the wrapper on a CPU copy
    ref = detect.detect_bursts_fused(cfg, s.cpu(), 2048)
    assert torch.equal(got["start"].cpu(), ref["start"])
    for key in ("cfo", "scale", "strength", "ac_peak", "noise_floor"):
        assert _close(got[key].cpu(), ref[key], **PEAK_TOL), key


@pytest.mark.parametrize("impl", ["pallas2", "pallas", "twostage"])
def test_streaming_service_fused_engine_on_card(impl, monkeypatch):
    import numpy as np

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


def test_detection_tile_too_large_for_shared_memory_raises():
    """K = 8192 needs ~260 KB of shared memory a CTA (taps and the 2K-sample
    windows): the launch is refused and each wrapper raises, naming its
    kernel."""
    from gfdm_tpu_torch.kernels import detect

    dev = _cuda()
    cfg = GfdmConfig(subcarriers=8192, active_subcarriers=8000, timeslots=3)
    s = torch.zeros(2, 2, 2 * 8192 + 300, device=dev)
    before = dict(detect.LAUNCHES)
    with pytest.raises(RuntimeError, match="gfdm_detect_lean kernel failed to launch"
                                           ".*the detect_lean tile keeps"):
        detect.detect_bursts_fused(cfg, s, 100)
    with pytest.raises(RuntimeError, match="gfdm_detect_front kernel failed to launch"
                                           ".*the detect_front tile keeps"):
        detect.detect_front_fused(cfg, s, 100)
    assert detect.LAUNCHES == before
