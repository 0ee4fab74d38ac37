"""The superseded receivers' stages (csrc/rx.cu), replayed on the CPU.

tests/rx_variant_emulation.py replays each launch of a receiver's plan
(``fused._variant_plan``) with the kernels' index arithmetic at float32:
the A operand read in place through its window (the preamble at cp and the
payload at preamble_len + cp of each burst row, pitch 2 frame_len; the
frames for rx_core / rx_ic), zero-filled past the batch and past N to the
tile; the three Gauss products, each sum over k in order from zero; the ZF
epilogue; the IC pass with its neighbour wrap; the hybrid's fold, IDFTs
and IC. The replay is held against the plain versions (_rx_variant_plain)
and against the JAX package's Pallas kernels in interpret mode (one block
of the whole batch) on the same numpy-seeded float32 inputs, with the
kernels' card limits (tests/test_torch_gpu.py): channel 2e-4, symbols 5e-4. The
configs: the canonical one (N = 576, nine column tiles) and K = 32, M = 5
(N = 160: a ragged last column tile); the batch, 67, is ragged too.
"""
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rx_variant_emulation as emu
from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.kernels import fused as jax_fused
from gfdm_tpu.ops import planar_pipeline as jax_pp
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import planar_payload
from gfdm_tpu_torch.kernels import fused

torch.set_num_threads(1)

B = 67  # not a multiple of the 64-burst tile
CONFIGS = {
    "canonical": {},
    "k32m5": {"subcarriers": 32, "active_subcarriers": 24, "timeslots": 5,
              "cp_len": 8, "cs_len": 4},
}
AMPS = {"qpsk": 2.0**-0.5, "scaled": 0.6}
TOL = {"chan": 2e-4, "symbols": 5e-4}
JAX_FNS = {"rx_core": "rx_core_fused", "rx_ic": "rx_ic_fused", "rx_full": "rx_full_fused",
           "rx_hybrid": "rx_receiver_hybrid"}


@lru_cache(maxsize=None)
def _inputs(name):
    """Noisy transmitted bursts (sigma 0.01, as tests/test_pallas.py), their
    payload blocks and the JAX package's channel estimate: numpy arrays."""
    jc = JaxConfig(**CONFIGS[name])
    data = planar_payload(jc, B, 100)
    bursts = np.asarray(jax_pp.transmit_planar(jc, jnp.asarray(data))[:, 0])
    noise = np.random.default_rng(104).standard_normal(bursts.shape)
    bursts = (bursts + 0.01 * noise).astype(np.float32)
    fs, n = jc.preamble_len + jc.cp_len, jc.block_len
    frames = np.ascontiguousarray(bursts[..., fs : fs + n])
    chan = jax_pp.receive_bursts_planar(jc, jnp.asarray(bursts), ic_iterations=0)["channel"]
    return bursts, frames, np.ascontiguousarray(np.asarray(chan, dtype=np.float32))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _args(key, name):
    """The receiver's torch input rows: (x, chan) with chan None where it
    estimates the channel itself."""
    bursts, frames, chan = _inputs(name)
    if key in ("rx_core", "rx_ic"):
        return _t(frames).reshape(B, -1), _t(chan).reshape(B, -1)
    return _t(bursts).reshape(B, -1), None


def _jax(key, name, iterations, amp):
    """The JAX package's Pallas kernel (interpret mode): (chan or None, symbols)."""
    jc = JaxConfig(**CONFIGS[name])
    bursts, frames, chan = _inputs(name)
    fn = getattr(jax_fused, JAX_FNS[key])
    if key == "rx_core":
        return None, np.asarray(fn(jc, jnp.asarray(frames), jnp.asarray(chan), block=B))
    kw = dict(ic_iterations=iterations, block=B, qpsk_amp=amp)
    if key == "rx_ic":
        return None, np.asarray(fn(jc, jnp.asarray(frames), jnp.asarray(chan), **kw))
    out = fn(jc, jnp.asarray(bursts), **kw)
    if key == "rx_hybrid":
        return np.asarray(out[0]), np.asarray(out[1])
    return None, np.asarray(out)


def _err(a, b):
    return float(np.abs(np.asarray(a).reshape(B, -1) - np.asarray(b).reshape(B, -1)).max())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_windows_read_in_place(name):
    """The loader's offsets pick each burst's preamble window and payload
    block out of the flat rows; rows past B and k past the width are 0."""
    cfg = GfdmConfig(**CONFIGS[name])
    bursts = _t(_inputs(name)[0])  # (B, 2, frame_len)
    win = emu.windows(cfg, "rx_full")
    cp, fs, half, n = cfg.cp_len, cfg.preamble_len + cfg.cp_len, 2 * cfg.subcarriers, cfg.block_len
    for key, (lo, width) in (("p", (cp, half)), ("f", (fs, n))):
        a = emu.load_window(bursts.reshape(-1), B, *win[key])
        assert a.shape == (128, 2, -(-width // emu.BK) * emu.BK)
        torch.testing.assert_close(a[:B, :, :width], bursts[..., lo : lo + width], rtol=0,
                                   atol=0)
        assert not a[B:].any() and not a[:, :, width:].any()
    frames = _t(_inputs(name)[1])
    a = emu.load_window(frames.reshape(-1), B, *emu.windows(cfg, "rx_core")["f"])
    torch.testing.assert_close(a[:B, :, :n], frames, rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stack_tiles_zero_fill_past_n(name):
    """The Gauss stack's planes in the tile layout: N = 160 fills two of
    three 64-column tiles and zero-pads the third."""
    cfg = GfdmConfig(**CONFIGS[name])
    n = cfg.block_len
    g = fused._kernel_consts(cfg, "cpu")["F_G"]
    w = emu.load_stack(g, n, n)
    assert w.shape == (3, -(-n // emu.BK) * emu.BK, -(-n // emu.BN) * emu.BN)
    for q in range(3):
        torch.testing.assert_close(w[q, :n, :n], g[q * n : (q + 1) * n], rtol=0, atol=0)
    assert not w[:, :, n:].any() and not w[:, n:].any()
    assert (n % emu.BN != 0) == (name == "k32m5")


@pytest.mark.parametrize("stack", ["E_G", "F_G", "Bfd_G"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gauss_tiles_match_gdot(name, stack):
    """The tiles' three products, in-order sums, combined as (p1 - p2,
    (p3 - p1) - p2): the plain version's _gdot within float32 rounding
    (sums over up to 576 terms in another order, and the Gauss
    combination's cancellation: 1.3e-6 of the largest output at most)."""
    cfg = GfdmConfig(**CONFIGS[name])
    n = cfg.block_len
    n_in = 2 * cfg.subcarriers if stack == "E_G" else n
    g = fused._kernel_consts(cfg, "cpu")[stack]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((B, 2 * n_in))
                         .astype(np.float32))
    got = emu.gemm_stage(x.reshape(-1), B, (0, 2 * n_in, n_in, n_in), g, n_in, n)
    ref = torch.cat(fused._gdot(x[:, :n_in], x[:, n_in:], g, n_in), dim=1)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_zf_epilogue_is_the_plain_divide(name):
    """The DFT stage's epilogue, one float32 operation at a time in the
    kernel's order, is _zf bit for bit, the 1e-30 clamp included."""
    cfg = GfdmConfig(**CONFIGS[name])
    n = cfg.block_len
    rng = np.random.default_rng(6)
    x, h = (torch.from_numpy(rng.standard_normal((B, 2 * n)).astype(np.float32))
            for _ in range(2))
    h[:, :7] = 0.0
    h[:, n : n + 7] = 0.0  # |h|^2 = 0: the clamp
    got = emu.zf(x[:, :n], x[:, n:], h[:, :n], h[:, n:])
    ref = fused._zf(x[:, :n], x[:, n:], h[:, :n], h[:, n:])[:2]
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert bool(torch.isfinite(got[0]).all())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ic_neighbours_wrap(name):
    """The IC pass's neighbours of subcarrier 0 are K - 1 and 1, of K - 1
    are K - 2 and 0: one decision at subcarrier 0 moves only those two."""
    cfg = GfdmConfig(**CONFIGS[name])
    K, M, n = cfg.subcarriers, cfg.timeslots, cfg.block_len
    lo, hi = emu.neighbours(K, M)
    assert int(lo[0]) == (K - 1) * M and int(hi[0]) == M
    assert int(lo[n - 1]) == (K - 2) * M and int(hi[n - 1]) == 0
    taps = fused._ic_operand(cfg, "conv", "cpu")

    def interference(d0):
        return d0 - emu.cancel_pass(cfg, d0, taps, torch.ones(n), 1)

    d0 = torch.full((1, 2 * n), -1.0)
    d0[0, 0] = 1.0
    diff = interference(d0) - interference(torch.full((1, 2 * n), -1.0))
    moved = torch.nonzero(diff[0, :n].abs() > 0).flatten() // M
    assert set(moved.tolist()) == {1, K - 1}


@pytest.mark.parametrize("iterations", [0, 1, 2, 3])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cancel_pass_is_the_plain_ic(name, iterations):
    """The IC pass with its index arithmetic equals _cancel_plain (conv IC,
    QPSK) bit for bit: each operation rounds as the plain version's."""
    cfg = GfdmConfig(**CONFIGS[name])
    n = cfg.block_len
    d0 = torch.from_numpy(np.random.default_rng(7).standard_normal((B, 2 * n))
                          .astype(np.float32)) * 0.7
    k = fused._kernel_consts(cfg, "cpu")
    taps = fused._ic_operand(cfg, "conv", "cpu", 0.6)
    got = emu.cancel_pass(cfg, d0, taps, k["act"], iterations)
    opts = fused._rx_options(iterations, qpsk_amp=0.6)
    ref = torch.cat(fused._cancel_plain(cfg, k["act"], d0[:, :n], d0[:, n:], opts, taps), 1)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("iterations", [0, 2])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_hybrid_pass_matches_plain(name, iterations):
    """The hybrid's per-burst pass (fold, IDFTs as in-order FMA chains, IC)
    on the replayed Y, against the plain hybrid's symbols."""
    cfg = GfdmConfig(**CONFIGS[name])
    x, _chan = _args("rx_hybrid", name)
    stages = {}
    emu.replay("rx_hybrid", cfg, x, None, iterations, AMPS["qpsk"], stages)
    got = emu.hybrid_pass(cfg, stages["dft_zf"], AMPS["qpsk"], iterations)
    ref = fused._rx_variant_plain("rx_hybrid", cfg, x, None, iterations, AMPS["qpsk"])[1]
    assert _err(got, ref) < 1e-5


def _check(key, name, iterations, amp):
    cfg = GfdmConfig(**CONFIGS[name])
    x, chan = _args(key, name)
    got_c, got_s = emu.replay(key, cfg, x, chan, iterations, amp)
    ref_c, ref_s = fused._rx_variant_plain(key, cfg, x, chan, iterations, amp)
    jax_c, jax_s = _jax(key, name, iterations, amp)
    assert got_s.shape == (B, 2 * cfg.block_len) and bool(torch.isfinite(got_s).all())
    assert _err(got_s, ref_s) < TOL["symbols"]
    assert _err(got_s, jax_s) < TOL["symbols"]
    if key == "rx_hybrid":
        assert _err(got_c, ref_c) < TOL["chan"]
        assert _err(got_c, jax_c) < TOL["chan"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rx_core_replay_matches_plain_and_pallas(name):
    _check("rx_core", name, 0, AMPS["qpsk"])


@pytest.mark.parametrize("amp", sorted(AMPS))
@pytest.mark.parametrize("key", ["rx_ic", "rx_full", "rx_hybrid"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_replay_matches_plain_and_pallas(name, key, amp):
    _check(key, name, 2, AMPS[amp])


@pytest.mark.parametrize("iterations", [0, 1, 3])
@pytest.mark.parametrize("key", ["rx_ic", "rx_full", "rx_hybrid"])
def test_replay_at_each_ic_depth(key, iterations):
    _check(key, "canonical", iterations, AMPS["scaled"])


@pytest.mark.parametrize("iterations", [0, 1, 2, 3])
@pytest.mark.parametrize("key", ["rx_ic", "rx_full", "rx_hybrid"])
def test_variant_launches(key, iterations):
    """One launch a stage: the estimate where the receiver estimates, DFT +
    ZF, then the demodulator and one IC launch where IC runs, or the
    hybrid's pass."""
    want = {"rx_ic": 2, "rx_full": 3, "rx_hybrid": 3}[key]
    if key != "rx_hybrid" and iterations > 0:
        want += 1
    assert fused.variant_launches(key, iterations) == want
    names = [name for name, _s, _it in fused._variant_plan(key, iterations)]
    assert names[-1] == ("hybrid" if key == "rx_hybrid" else
                         "cancel" if iterations else "demod")


def test_rx_core_launches_and_refusals():
    assert fused.variant_launches("rx_core") == 2
    with pytest.raises(ValueError, match="no IC"):
        fused.variant_launches("rx_core", 1)
    with pytest.raises(ValueError, match="unknown key"):
        fused.variant_launches("rx_dense", 0)
