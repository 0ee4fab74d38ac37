"""The staged tensor-core receiver (csrc/link.cu, rx_receiver_fused on a
card) on the CPU: its launch plan, its arithmetic and the burst windows its
stages read in place, without a card.

The receiver's stages sum the products of the float32 Gauss stacks in
float64 on the FP64 tensor cores (every product of float32 operands is
exact there) and round once: the plain version summed in float64
(fused._gdot64). Here every float32-stack product of the plain receiver is
replaced by that arithmetic and the result held against the JAX package's
Pallas receiver in interpret mode (B = 8, block 4), on every option case of
tests/test_torch_options.py; and on noisy qam64 bursts the float32 plain
version and the 3xTF32 products each against it, which is why it is the
reference. tests/test_torch_gpu.py holds the stages themselves against the
plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdm_tpu.kernels import fused as jax_fused
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import large_k_config
from gfdm_tpu_torch.kernels import fused
from gfdm_tpu_torch.ops.rx import constellation_points
from test_torch_options import CASES, JC, TC, _case_bursts
from tf32_emulation import gdot_3xtf32

torch.set_num_threads(1)

K32 = dict(subcarriers=32, active_subcarriers=24, timeslots=5, cp_len=8, cs_len=4)
# the JAX package's limits for its fused receiver (tests/test_pallas.py)
CHAN_ATOL, SYM_ATOL, SNR_RTOL = 2e-4, 5e-4, 1e-3
RX_CASES = {**CASES, "zf-qpsk": ({}, "qpsk", 0.05)}


def _kernel_products(monkeypatch):
    """Patch the plain receiver's products to the staged kernels'
    arithmetic: float32 stacks summed in float64 and rounded once, the bf16
    IC operator as _gdot (bf16 tensor cores, float32 sums). Returns the list
    that collects each float32 stack."""
    plain, stacks = fused._gdot, []

    def gdot(xr, xi, g, n_in):
        if g.dtype == torch.bfloat16:
            return plain(xr, xi, g, n_in)
        stacks.append(g)
        return fused._gdot64(xr, xi, g, n_in)

    monkeypatch.setattr(fused, "_gdot", gdot)
    return stacks


@pytest.mark.parametrize("phase", [False, True])
@pytest.mark.parametrize("ic_iterations", [0, 1, 2, 3])
@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
def test_rx_launch_plan(ic_mode, ic_iterations, phase):
    """One launch a stage: preamble DFT, metrics, estimate + DFT + ZF (whose
    mmse weights read the metrics), demod, the phase stage only where an IC
    iteration follows, then one an IC iteration. The CPU path launches
    nothing."""
    n = fused.rx_launches(ic_iterations, phase)
    with_phase = phase and ic_iterations > 0
    assert n == 4 + with_phase + ic_iterations
    plan = fused._rx_plan(ic_iterations, phase)
    assert len(plan) == n
    names = [p[0] for p in plan]
    assert names == list(fused.RX_STAGES) + ["phase"] * with_phase + ["ic"] * ic_iterations
    assert names.index("metrics") < names.index("est_zf")
    assert [p[1] for p in plan] == [fused._STAGE[name] for name in names]
    assert [p[2] for p in plan[n - ic_iterations :]] == list(range(ic_iterations))
    # the stage numbers of csrc/link.cu gfdm::lg::Stage, the link's plan alike
    assert fused._STAGE == {"tx": 0, "est_zf": 1, "pre_dft": 2, "metrics": 3, "demod": 4,
                            "ic": 5, "phase": 6}
    before = dict(fused.LAUNCHES)
    bursts = torch.from_numpy(_case_bursts("qpsk", 0.05)[:3].copy())
    chan, sym, _met = fused.rx_receiver_fused(TC, bursts, ic_iterations=ic_iterations,
                                              ic_mode=ic_mode, phase_compensation=phase)
    assert sym.shape == chan.shape == (3, 2, TC.block_len) and fused.LAUNCHES == before


@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
@pytest.mark.parametrize("case", sorted(RX_CASES))
def test_rx_summed_in_float64_matches_pallas(case, ic_mode, monkeypatch):
    """The receiver with its four float32-stack products (estimate,
    preamble DFT, block DFT, demod) summed in float64 against the Pallas
    receiver at JAX's limits: channel 2e-4, SNR rtol 1e-3, symbols 5e-4 but
    for at most one burst of eight (a decision at a level boundary, as
    tests/test_torch_options.py counts them). The clean rotated bursts of
    the phase case leave only rounding residue in the noise bins, so their
    SNR (~7e13 in JAX) is checked as that of a noiseless burst in both."""
    options, kind, sigma = RX_CASES[case]
    bursts = _case_bursts(kind, sigma)
    chan_r, sym_r, met_r = (np.asarray(x) for x in jax_fused.rx_receiver_fused(
        JC, jnp.asarray(bursts), ic_iterations=2, block=4, ic_mode=ic_mode, **options))
    stacks = _kernel_products(monkeypatch)
    chan, sym, met = fused.rx_receiver_fused(TC, torch.from_numpy(bursts), ic_iterations=2,
                                             ic_mode=ic_mode, **options)
    assert len(stacks) == 4 and all(g.dtype == torch.float32 for g in stacks)
    np.testing.assert_allclose(chan.numpy(), chan_r, atol=CHAN_ATOL)
    per_burst = np.abs(sym.numpy() - sym_r).reshape(len(bursts), -1).max(axis=1)
    assert (per_burst >= SYM_ATOL).sum() <= 1
    assert per_burst[per_burst < SYM_ATOL].max() < SYM_ATOL
    if sigma > 0:
        np.testing.assert_allclose(met[:, 0].numpy(), met_r[:, 0], rtol=SNR_RTOL)
    else:
        assert (met[:, 0].numpy() > 1e12).all() and (met_r[:, 0] > 1e12).all()


def _flipped(rows, ref_rows, act2):
    """Bursts whose last IC decisions (made on the rows after 1 of 2
    iterations) differ from the reference's, and whether each such burst is
    explained by decisions within 1e-5 of a level boundary, at that
    iteration or at the first (whose flip moves the inputs of the last)."""
    scale, _lim = fused._QAM_LEVELS["qam64"]
    diff, near = [], []
    for u, r in zip(rows, ref_rows):
        d = (fused._ic_level(u, "qam64") != fused._ic_level(r, "qam64")) & (act2 != 0)
        t = (u * scale - 1.0) / 2.0
        diff.append(d.any(dim=1))
        near.append((~d | ((t - t.floor() - 0.5).abs() < 1e-5)).all(dim=1))
    flipped = diff[1]
    explained = (diff[1] & near[1]) | (diff[0] & near[0]) | ~flipped
    return int(flipped.sum()), bool(explained.all())


def test_float32_level_sums_flip_noisy_qam64_decisions():
    """Why the receiver sums in float64 and its decisions are held to the
    plain version summed in float64: on 8,192 noisy qam64 bursts (20 dB,
    mmse, conv IC) both float32-level sums - the float32 plain version and
    the 3xTF32 products (tests/tf32_emulation.py) - take last IC decisions
    on the other side of a level boundary from the float64 sums, and from
    each other, in some 1e-4 to 3e-3 of the bursts (here 10, 4 and 12 of
    8,192), each within 1e-5 of the boundary. So a kernel summing at float32
    level in its own order cannot be held to the 1e-3 limit against the
    float32 plain version, while float64 sums leave only their one
    rounding."""
    B = 8192
    pts = constellation_points("qam64")
    idx = np.random.default_rng(83).integers(0, pts.size, (B, TC.n_data_symbols))
    data = np.concatenate([pts[idx].real, pts[idx].imag], axis=1).astype(np.float32)
    bursts = fused._tx_frame_plain(TC, torch.from_numpy(data))
    sig_pow = float((bursts**2).sum(dim=1).mean()) / TC.frame_len  # |x|^2 a sample
    noise = np.random.default_rng(93).standard_normal(tuple(bursts.shape), dtype=np.float32)
    rows = bursts + (sig_pow / 100.0 / 2) ** 0.5 * torch.from_numpy(noise)
    act = fused._kernel_consts(TC, "cpu")["act"]
    act2 = torch.cat([act, act])
    kw = dict(constellation="qam64", equalizer="mmse")
    out = {name: [fused._rx_receiver_plain(TC, rows, it, "conv", gdot=gdot, **kw)[1]
                  for it in (0, 1)]
           for name, gdot in (("float64", fused._gdot64), ("float32", None),
                              ("3xtf32", gdot_3xtf32))}
    counts = {}
    for a, b in (("float32", "float64"), ("3xtf32", "float64"), ("3xtf32", "float32")):
        counts[a, b], explained = _flipped(out[a], out[b], act2)
        assert explained, (a, b)
    assert all(1 <= n <= 3e-3 * B for n in counts.values()), counts


def _config(name):
    return {"canonical": GfdmConfig(), "k32m5": GfdmConfig(**K32), "k128": large_k_config(128),
            "k256": large_k_config(256), "k512": large_k_config(512)}[name]


@pytest.mark.parametrize("name", ["canonical", "k32m5", "k128"])
def test_burst_windows_are_the_plain_receivers_slices(name):
    """The receiver's stages read P and F in place: element (b, q, k) of a
    window (offset, ld, im, width) at offset + b ld + q im + k of the burst
    rows. That selects exactly _rx_receiver_plain's slices, inside each
    row."""
    cfg = _config(name)
    B, L, n, half = 5, cfg.frame_len, cfg.block_len, 2 * cfg.subcarriers
    cp, fs = cfg.cp_len, cfg.preamble_len + cfg.cp_len
    rows = torch.from_numpy(np.random.default_rng(6).standard_normal((B, 2 * L))
                            .astype(np.float32))
    plain = {"p": (rows[:, cp : cp + half], rows[:, L + cp : L + cp + half]),
             "f": (rows[:, fs : fs + n], rows[:, L + fs : L + fs + n])}
    windows = fused._burst_windows(cfg)
    assert sorted(windows) == ["f", "p"]
    for key, (off, ld, im, width) in windows.items():
        assert ld == rows.shape[1] and off + im + width <= ld
        got = rows.as_strided((B, 2, width), (ld, im, 1), off)
        assert torch.equal(got, torch.stack(plain[key], dim=1)), key


@pytest.mark.parametrize("name", ["canonical", "k128", "k256", "k512"])
def test_burst_windows_take_the_16_byte_copies(name):
    """gfdm::lg::Act::vec(): a window is copied 16 bytes at a time where its
    start (from a 16-byte-aligned burst tensor), row pitch, plane pitch and
    width are whole numbers of 4 floats: the canonical config and every
    large-K config the receiver takes."""
    for off, ld, im, width in fused._burst_windows(_config(name)).values():
        assert (4 * off) % 16 == 0 and ld % 4 == 0 and im % 4 == 0 and width % 4 == 0


def test_rx_size_check_refuses_k1024():
    """K = 1024 (N = 9216) would need 1 GB float32 stacks: the check the
    receiver runs on a card before any constant raises, naming the factored
    receiver; K = 512 passes."""
    with pytest.raises(ValueError, match="rx_receiver_fused: N = 9216.*rx_receiver_factored"):
        fused._check_dense_size(large_k_config(1024), "rx_receiver_fused",
                                "rx_receiver_factored")
    fused._check_dense_size(large_k_config(512), "rx_receiver_fused", "rx_receiver_factored")
