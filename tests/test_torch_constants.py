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
    })
    for key, t in ours.items():
        assert t.dtype == theirs[key].dtype, key
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_bits(t), _bits(theirs[key]), err_msg=key)
        else:
            assert torch.equal(t, theirs[key]), key


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
