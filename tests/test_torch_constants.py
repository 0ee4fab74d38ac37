"""The port's config, golden modules and constants against the JAX package.

Same inputs, built by both packages: every derived array must be equal, and
every operator and constant the port builds must be bit-equal to the JAX
package's arrays carried across by ``gfdm_tpu_torch.convert``.
"""
import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.kernels import fused as jax_fused
from gfdm_tpu.ops import operators as jax_ops
from gfdm_tpu.ops import planar_pipeline as jax_pp
from gfdm_tpu.ops.tx import demap_indices as jax_demap_indices
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.convert import operators_from_numpy
from gfdm_tpu_torch.kernels import fused
from gfdm_tpu_torch.ops import operators
from gfdm_tpu_torch.ops import planar_pipeline as pp

torch.set_num_threads(1)

CONFIGS = {
    "canonical": {},
    "shifts": {"cyclic_shifts": (0, 4)},
    "k32m5": {"subcarriers": 32, "active_subcarriers": 24, "timeslots": 5,
              "cp_len": 8, "cs_len": 4},
    "k128": {"subcarriers": 128, "active_subcarriers": 100, "timeslots": 9,
             "cp_len": 32, "cs_len": 16},
}
SCALARS = ("block_len", "window_len", "n_data_symbols", "preamble_len",
           "frame_len", "pre_padding_len", "post_padding_len", "ramp_len")
ARRAYS = ("subcarrier_map", "tx_filter_taps", "rx_filter_taps", "window_taps",
          "full_preambles", "core_preamble")
AMP = 2.0**-0.5


def _pair(name):
    kw = CONFIGS[name]
    return JaxConfig(**kw), GfdmConfig(**kw)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_derived_arrays_equal(name):
    jc, tc = _pair(name)
    for attr in SCALARS:
        assert getattr(tc, attr) == getattr(jc, attr), attr
    for attr in ARRAYS:
        np.testing.assert_array_equal(getattr(tc, attr), getattr(jc, attr), err_msg=attr)


@pytest.mark.parametrize("name", ["canonical", "k32m5"])
def test_operators_equal(name):
    jc, tc = _pair(name)
    for fn in ("modulation_operator", "demodulation_fd_operator", "tx_core_operator",
               "channel_estimation_operator", "cnr_interpolation_operator",
               "cp_window", "mapping_matrix"):
        np.testing.assert_array_equal(getattr(operators, fn)(tc),
                                      getattr(jax_ops, fn)(jc), err_msg=fn)
    for shift in (0, 3):
        np.testing.assert_array_equal(operators.tx_frame_operator(tc, shift),
                                      jax_ops.tx_frame_operator(jc, shift))
        np.testing.assert_array_equal(operators.cp_indices(tc, shift),
                                      jax_ops.cp_indices(jc, shift))
    np.testing.assert_array_equal(operators.demap_indices(tc), jax_demap_indices(jc))
    np.testing.assert_array_equal(operators._interference_matrix(tc),
                                  jax_pp._interference_matrix(jc))


@pytest.mark.parametrize("name", ["canonical", "shifts"])
def test_planar_cache_bit_equal_to_converted_jax_arrays(name):
    jc, tc = _pair(name)
    ours = pp._device_mats(tc, "float32", "cpu")
    theirs = operators_from_numpy(
        {**jax_pp._np_mats(jc, "float32"), **jax_pp._small_consts(jc, "float32")}
    )
    assert set(ours) <= set(theirs)
    for key, t in ours.items():
        assert t.dtype == theirs[key].dtype, key
        assert torch.equal(t, theirs[key]), key


@pytest.mark.parametrize("name", ["canonical", "k32m5"])
def test_fast_planar_cache_bit_equal_to_converted_jax_arrays(name):
    """method="fast": the small-operator set (no O(N^2) matrix) and the
    small constants, plus the Tx map index of the JAX _tx_fast_fn loop."""
    jc, tc = _pair(name)
    ours = dict(pp._device_mats(tc, "float32", "cpu", "fast"))
    theirs = operators_from_numpy(
        {**jax_pp._np_mats_fast(jc, "float32"), **jax_pp._small_consts(jc, "float32")}
    )
    map_idx = ours.pop("map_idx")
    assert set(ours) <= set(theirs)
    for key, t in ours.items():
        assert t.dtype == theirs[key].dtype and torch.equal(t, theirs[key]), key
    want = np.full(jc.block_len, jc.n_data_symbols)
    rows, cols = np.nonzero(jax_ops.mapping_matrix(jc).real)
    want[rows] = cols
    assert map_idx.dtype == torch.int32
    np.testing.assert_array_equal(map_idx.numpy(), want)


def _jax_factored_np(jc):
    from gfdm_tpu.ops import planar_fast as jax_pf

    return {**jax_fused._factored_consts(jc), **jax_fused._tx_factored_consts(jc),
            **jax_pf._fft_consts(jc, "float32"), **jax_pf._est_consts(jc, "float32")}


@pytest.mark.parametrize("name", ["canonical", "k32m5", "k128"])
def test_factored_consts_bit_equal_to_converted_jax_arrays(name):
    """The factored kernels' cache against the JAX factored kernels' and
    planar_fast's tables: kept tables bit-equal, coefficient rows and
    gathers checked against the index patterns the CUDA kernels compute."""
    from gfdm_tpu_torch.convert import factored_consts_from_numpy

    jc, tc = _pair(name)
    theirs = factored_consts_from_numpy(_jax_factored_np(jc))
    assert not {"mcr", "ftr", "ivr", "reorder", "txar", "ftxr", "mtr", "unreorder"} & set(theirs)
    # E_W: the dense estimator of estimator="fused", in the cache once an
    # earlier test in this process has used it
    small = operators_from_numpy({**jax_pp._small_consts(jc, "float32"),
                                  "E_W": jax_pp._np_mats(jc, "float32")["E_W"]})
    ours = fused._factored_consts(tc, "cpu")
    for key, t in ours.items():
        if key in ("ftaps", "map_idx", "act"):  # test_torch_factored.py pins these
            continue
        ref = theirs[key] if key in theirs else small[key]
        assert t.dtype == ref.dtype and torch.equal(t, ref), key
    assert set(theirs) <= set(ours)


def test_convert_rejects_a_wrong_factored_table():
    from gfdm_tpu_torch.convert import factored_consts_from_numpy

    c = _jax_factored_np(JaxConfig())
    for name, delta in (("mcr", 1e-4), ("ftr", 1e-7), ("reorder", 1)):
        bad = dict(c)
        bad[name] = c[name].copy()
        bad[name].flat[5] += delta
        with pytest.raises(ValueError, match=name[:-1] if name != "reorder" else name):
            factored_consts_from_numpy(bad)
    with pytest.raises(ValueError, match="needs FM_W"):
        factored_consts_from_numpy({k: c[k] for k in ("mcr", "mci", "tw")})


@pytest.mark.parametrize("name", ["canonical", "k32m5"])
def test_kernel_consts_bit_equal_to_converted_jax_arrays(name):
    jc, tc = _pair(name)
    ours = dict(fused._kernel_consts(tc, "cpu"))
    ours["icop"] = fused._ic_operand(tc, "matmul", "cpu")
    theirs = operators_from_numpy({
        **jax_pp._np_mats(jc, "float32"),
        **jax_pp._small_consts(jc, "float32"),
        "met_selection": jax_fused._met_selection(jc),
        "circ_masks": jax_fused._circ_masks(jc),
        "ic_matmul_stack": jax_fused._ic_matmul_stack(jc, AMP),
        "demap_selection": jax_fused._demap_selection(jc),
        "cnri_pad": jax_fused._cnri_pad(jc),
    })
    for key, t in ours.items():
        assert t.dtype == theirs[key].dtype, key
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_bits(t), _bits(theirs[key]), err_msg=key)
        else:
            assert torch.equal(t, theirs[key]), key


@pytest.mark.parametrize("amp", ["qam16", "qam64", "override"])
@pytest.mark.parametrize("name", ["canonical", "k32m5"])
def test_ic_consts_per_amplitude_bit_equal_to_converted_jax_arrays(name, amp):
    """The IC constants at each amplitude: the bf16 operator stack and the
    conv taps, with the JAX block-diagonal C of _rx_ic_kernel and the
    realified C_W of _rx_full_kernel checked against those taps."""
    jc, tc = _pair(name)
    a = {"override": 0.6, **jax_fused._IC_AMPS}[amp]
    theirs = operators_from_numpy({
        "C_W": jax_pp._np_mats(jc, "float32")["C_W"],
        "ic_matmul_stack": jax_fused._ic_matmul_stack(jc, a),
        "block_diag_C": jax_fused._block_diag_C(jc),
    }, amp=a)
    np.testing.assert_array_equal(_bits(fused._ic_operand(tc, "matmul", "cpu", a)),
                                  _bits(theirs["icop"]))
    assert torch.equal(fused._ic_operand(tc, "conv", "cpu", a), theirs["taps"])
    assert fused._IC_AMPS == jax_fused._IC_AMPS


@pytest.mark.parametrize("name", ["canonical", "k32m5"])
def test_bf16_gauss_stacks_bit_equal_to_jax(name):
    """link_single_fused(dtype_name="bfloat16"): the five stacks, each part
    rounded once from float64 by torch and the sum plane taken in bf16, are
    ml_dtypes' bits."""
    jc, tc = _pair(name)
    ours = fused._stacks(tc, "cpu", "bfloat16")
    theirs = operators_from_numpy({k: v for k, v in jax_pp._np_mats(jc, "bfloat16").items()
                                   if k.endswith("_G")})
    assert set(ours) == set(theirs) == {"T_G", "E_G", "F_G", "Bfd_G", "F2_G"}
    for key, t in ours.items():
        assert t.dtype == theirs[key].dtype == torch.bfloat16, key
        np.testing.assert_array_equal(_bits(t), _bits(theirs[key]), err_msg=key)


@pytest.mark.parametrize("name", ["shifts", "k32m5"])
def test_tx_port_shifts_are_the_cp_gathers(name):
    """The Tx kernel's per-port shifts against the JAX package's CP/CS
    gather of each port: frame position i holds core sample
    (i - cp - shift) mod N."""
    jc, tc = _pair(name)
    cp_idx = jax_pp._small_consts(jc, "float32")["cp_idx"]
    W, n = cp_idx.shape[1], jc.block_len
    for s, shift in enumerate(fused._shifts(tc, "cpu").tolist()):
        np.testing.assert_array_equal(cp_idx[s], (np.arange(W) - jc.cp_len - shift) % n)


def test_convert_rejects_a_wrong_block_diag_or_cnri_pad():
    jc = JaxConfig()
    cw = jax_pp._np_mats(jc, "float32")["C_W"]
    bdr, bdi = (x.copy() for x in jax_fused._block_diag_C(jc))
    bdr[0, 1] += 1e-3
    with pytest.raises(ValueError, match="block_diag_C"):
        operators_from_numpy({"C_W": cw, "block_diag_C": (bdr, bdi)})
    pad = jax_fused._cnri_pad(jc).copy()
    pad[-1, 0] = 1.0
    with pytest.raises(ValueError, match="cnri_pad"):
        operators_from_numpy({"met_selection": jax_fused._met_selection(jc), "cnri_pad": pad})


@pytest.mark.parametrize("name", ["canonical", "k32m5", "k128"])
def test_ic_matmul_stack_bf16_bits_pinned(name):
    """torch's float64 -> bf16 rounding matches ml_dtypes' on every entry."""
    jc, tc = _pair(name)
    ours = _bits(fused._ic_matmul_stack(tc, AMP))
    theirs = jax_fused._ic_matmul_stack(jc, AMP).view(np.int16)
    assert ours.shape == theirs.shape == (3 * tc.block_len, tc.block_len)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_met_layout_equal(name):
    jc, tc = _pair(name)
    assert fused._met_layout(tc) == jax_fused._met_layout(jc)


def test_convert_rejects_disagreeing_inputs():
    jc = JaxConfig()
    small = dict(jax_pp._small_consts(jc, "float32"))
    small["sig_idx"] = small["sig_idx"][::-1].copy()
    with pytest.raises(ValueError, match="sig_idx"):
        operators_from_numpy({**small, "met_selection": jax_fused._met_selection(jc)})
    masks = jax_fused._circ_masks(jc).copy()
    masks[0, 0] = 0.0
    with pytest.raises(ValueError, match="circ_masks"):
        operators_from_numpy({"ic_taps": small["ic_taps"], "circ_masks": masks})


# ---------------------------------------------------------------------------
# detection constants and the sync golden modules
# ---------------------------------------------------------------------------
def _same_bits(ours: torch.Tensor, theirs: np.ndarray, name: str):
    if ours.dtype == torch.bfloat16:
        np.testing.assert_array_equal(_bits(ours), np.asarray(theirs).view(np.int16),
                                      err_msg=name)
    else:
        assert ours.dtype == torch.float32 and np.asarray(theirs).dtype == np.float32
        np.testing.assert_array_equal(ours.numpy(), theirs, err_msg=name)


@pytest.mark.parametrize("name", ["canonical", "k32m5", "k128"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_detection_constants_bit_equal(name, dtype_name):
    """_detect_consts and _poly_consts: the float64 -> float32 / bf16
    rounding of torch matches numpy's / ml_dtypes' on every entry."""
    jc, tc = _pair(name)
    _same_bits(pp._detect_consts(tc, dtype_name), jax_pp._detect_consts(jc, dtype_name),
               "detect_consts")
    ours, theirs = pp._poly_consts(tc, dtype_name), jax_pp._poly_consts(jc, dtype_name)
    assert ours["b"] == theirs["b"] == 2 * tc.subcarriers
    assert set(ours["bands"]) == set(theirs["bands"])
    for w, band in ours["bands"].items():
        _same_bits(band, theirs["bands"][w], f"band{w}")
    _same_bits(ours["xcorr"], theirs["xcorr"], "xcorr")


@pytest.mark.parametrize("name", ["canonical", "k32m5", "k128"])
@pytest.mark.parametrize("which", ["_consts", "_consts2"])
def test_detect_kernel_consts_bit_equal_to_converted_jax_arrays(name, which):
    from gfdm_tpu.kernels import detect as jax_detect

    from gfdm_tpu_torch.convert import detect_consts_from_numpy
    from gfdm_tpu_torch.kernels import detect

    jc, tc = _pair(name)
    theirs = detect_consts_from_numpy(getattr(jax_detect, which)(jc))
    assert (theirs["K"], theirs["cp_len"]) == (tc.subcarriers, tc.cp_len)
    ours = detect._consts(tc, "cpu")
    assert ours["taps"].dtype == torch.float32 and torch.equal(ours["taps"], theirs["taps"])
    # the plain versions' conv weights are the same taps as a complex product
    assert torch.equal(ours["conv"], pp._detect_consts(tc, "float32"))


def test_convert_rejects_a_wrong_detection_operator():
    from gfdm_tpu.kernels import detect as jax_detect

    from gfdm_tpu_torch.convert import detect_consts_from_numpy

    c = dict(jax_detect._consts2(JaxConfig()))
    c["bandCP"] = c["bandCP"] * 2.0
    with pytest.raises(ValueError, match="bandCP"):
        detect_consts_from_numpy(c)
    c = dict(jax_detect._consts(JaxConfig()))
    x = c["xcorr"].copy()
    x[5, 0] += 1.0
    c["xcorr"] = x
    with pytest.raises(ValueError, match="xcorr"):
        detect_consts_from_numpy(c)


def test_sync_golden_copies_equal():
    """The port's copies of ref.synchronization, ref.correlation and
    ref.symbolmapping compute what the JAX package's originals compute."""
    from gfdm_tpu.ref import correlation as jcorr
    from gfdm_tpu.ref import symbolmapping as jsm
    from gfdm_tpu.ref import synchronization as jsync

    from gfdm_tpu_torch.ref import correlation as tcorr
    from gfdm_tpu_torch.ref import symbolmapping as tsm
    from gfdm_tpu_torch.ref import synchronization as tsync

    for pfa in (1e-2, 1e-5, 0.5):
        assert tsync.threshold_factor(pfa) == jsync.threshold_factor(pfa)
    with pytest.raises(ValueError):
        tsync.threshold_factor(1.0)
    rng = np.random.default_rng(9)
    s = rng.standard_normal(900) + 1j * rng.standard_normal(900)
    p = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    for fn in ("cross_correlate_valid", "cross_correlate_full"):
        np.testing.assert_array_equal(getattr(tcorr, fn)(s, p), getattr(jcorr, fn)(s, p))
    np.testing.assert_array_equal(tcorr.moving_sum(s, 9), jcorr.moving_sum(s, 9))
    assert tcorr.auto_correlate_halves(s) == jcorr.auto_correlate_halves(s)
    jc, tc = _pair("canonical")
    x = np.concatenate([np.zeros(100), tc.full_preambles[0], np.zeros(300)])
    x = x + 0.01 * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
    got = tsync.find_frame_start(x, tc.core_preamble, tc.subcarriers, tc.cp_len)
    ref = jsync.find_frame_start(x, jc.core_preamble, jc.subcarriers, jc.cp_len)
    assert (got.frame_start, got.cfo, got.coarse_peak) == (
        ref.frame_start, ref.cfo, ref.coarse_peak)
    np.testing.assert_array_equal(got.gated_xcorr, ref.gated_xcorr)
    np.testing.assert_array_equal(tsync.correct_frequency_offset(s, 0.1, 64),
                                  jsync.correct_frequency_offset(s, 0.1, 64))
    for order in (1, 2, 4, 6):
        np.testing.assert_array_equal(tsm.constellation(order), jsm.constellation(order))
    pts = tsm.constellation(4)
    bits = rng.integers(0, 2, 64)
    sym = tsm.bits_to_symbols(bits, pts)
    np.testing.assert_array_equal(sym, jsm.bits_to_symbols(bits, pts))
    np.testing.assert_array_equal(tsm.symbols_to_bits(sym, pts), bits)
    np.testing.assert_array_equal(tsm.hard_decide(sym + 0.1, pts),
                                  jsm.hard_decide(sym + 0.1, pts))


def test_constellation_points_equal():
    from gfdm_tpu.ops.rx import constellation_points as jax_points

    from gfdm_tpu_torch.ops.rx import constellation_points

    for name in ("qpsk", "qam16", "qam64"):
        np.testing.assert_array_equal(constellation_points(name), jax_points(name))
    with pytest.raises(ValueError, match="constellation"):
        constellation_points("8psk")
