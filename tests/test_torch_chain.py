"""The link's GEMM chain's plain versions against benchmarks/int8_gauss.py (CPU).

The script's own ``build`` runs on the CPU with ``pl.pallas_call`` wrapped to
drop the TPU memory space and run in interpret mode (``build`` asks for the
TPU's VMEM), so its kernel bodies, weight casts, int8 weight quantization
and ``x * s`` are the reference. The port's plain versions
(gfdm_tpu_torch.kernels.chain on CPU tensors) take the same numpy-seeded
inputs at the real shapes, B = 256 (two 128-row groups), the second
group's rows scaled by 10 so that a global absmax in place of the per-group
one shows. Limits (max |d| / max |ref|): f32 1e-5 (float32 sums in another
order), bf16 1e-2 (a sum on the other side of a bf16 rounding boundary
moves one activation by a bf16 ulp), int8 equal (integer sums are exact and
the float steps are the same). tests/test_torch_gpu.py holds the CUDA
kernels against these plain versions on the card.
"""
import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gfdm_tpu_torch.benchmarks import int8_gauss as port_bench
from gfdm_tpu_torch.convert import chain_weights_from_numpy
from gfdm_tpu_torch.kernels import chain

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
B = 256
LIMITS = {"f32": 1e-5, "bf16": 1e-2, "int8": 0.0}
NARROW = [(936, 48), (48, 48), (48, 48)]


@functools.lru_cache(maxsize=1)
def _script():
    spec = importlib.util.spec_from_file_location("int8_gauss_script",
                                                  ROOT / "benchmarks" / "int8_gauss.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret_build(monkeypatch, variant, batch, shapes, weights):
    """The script's build(variant, batch, 128, shapes, weights) with its
    pallas_call in interpret mode; returns (fn, what build handed the
    kernel: the kernel and its weight arrays)."""
    seen = {}
    real = pl.pallas_call

    def pallas_call(kernel, *, out_shape, grid, in_specs, out_specs):
        seen["kernel"] = kernel
        plain = lambda s: pl.BlockSpec(s.block_shape, s.index_map)  # noqa: E731
        call = real(kernel, out_shape=out_shape, grid=grid,
                    in_specs=[plain(s) for s in in_specs], out_specs=plain(out_specs),
                    interpret=True)

        def run(*args):
            seen["weights"] = [np.asarray(w) for w in args[1:]]
            return call(*args)

        return run

    monkeypatch.setattr(pl, "pallas_call", pallas_call)
    return _script().build(variant, batch, 128, shapes, weights), seen


def _inputs(shapes, batch=B, seed=0):
    rng = np.random.default_rng(seed)
    weights = [rng.standard_normal(s).astype(np.float32) / np.sqrt(s[0]) for s in shapes]
    x = rng.standard_normal((batch, shapes[0][0])).astype(np.float32)
    x[128:256] *= 10.0
    return weights, x


def _rel(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("shapes", [chain.CHAIN_SHAPES, NARROW], ids=["link", "narrow"])
@pytest.mark.parametrize("variant", chain.VARIANTS)
def test_plain_chain_matches_the_script(monkeypatch, variant, shapes):
    weights, x = _inputs(shapes)
    s = np.float32(1.0 + 3e-6)
    fn, _seen = _interpret_build(monkeypatch, variant, B, shapes, weights)
    ref = np.asarray(fn(jnp.asarray(x), s))
    cw = chain_weights_from_numpy(weights, variant)
    before = dict(chain.LAUNCHES)
    got = port_bench.chain_step(torch.from_numpy(x), s, cw)
    assert chain.LAUNCHES == before
    assert got.dtype == torch.float32 and got.shape == (B, shapes[-1][1])
    assert _rel(got.numpy(), ref) <= LIMITS[variant]
    if variant == "int8":
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("variant", ["bf16", "int8"])
def test_weights_are_the_scripts(monkeypatch, variant):
    """bf16: each weight rounded once from the script's numpy values (its
    ml_dtypes cast), bit for bit; int8: build's quantized weights and the
    inverse scales its kernel closes over; in both the CUDA operand is their
    zero-padded transpose."""
    weights, _x = _inputs(chain.CHAIN_SHAPES)
    fn, seen = _interpret_build(monkeypatch, variant, B, chain.CHAIN_SHAPES, weights)
    fn(jnp.zeros((B, 936), jnp.float32), np.float32(1.0))
    cw = chain_weights_from_numpy(weights, variant)
    for theirs, ours in zip(seen["weights"], cw.w):
        if variant == "bf16":
            assert ours.dtype == torch.bfloat16
            np.testing.assert_array_equal(theirs.view(np.int16), ours.view(torch.int16).numpy())
        else:
            assert ours.dtype == torch.int8
            np.testing.assert_array_equal(theirs, ours.numpy())
    if variant == "int8":
        invs = seen["kernel"].args[0]  # functools.partial(_chain_int8, invs)
        assert [np.float32(v) for v in cw.inv] == list(invs)
    for wq, wt in zip(cw.w, cw.w_t):
        d_in = wq.shape[0]
        assert wt.dtype == wq.dtype and wt.shape == (wq.shape[1], -(-d_in // 64) * 64)
        assert torch.equal(wt[:, :d_in], wq.T) and not wt[:, d_in:].any()


def test_int8_scales_are_per_group():
    """The 128-row group is part of the function: a group's output does not
    depend on another group's rows, and one scale for the whole batch would
    quantize the quiet group coarser."""
    weights, x = _inputs(chain.CHAIN_SHAPES)
    cw = chain_weights_from_numpy(weights, "int8")
    full = chain.gemm_chain(torch.from_numpy(x), cw)
    for g in range(2):
        rows = torch.from_numpy(x[128 * g : 128 * (g + 1)])
        assert torch.equal(chain.gemm_chain(rows, cw), full[128 * g : 128 * (g + 1)])
    ref = x.astype(np.float64) @ weights[0] @ weights[1] @ weights[2]
    loud = np.abs(ref[128:]).max()
    # the quiet group's error, relative to its own scale, stays at int8 level
    quiet = np.abs(full[:128].numpy() - ref[:128]).max() / np.abs(ref[:128]).max()
    assert quiet < 0.05 and loud > 5 * np.abs(ref[:128]).max()


def test_rejects_what_the_kernels_do_not_take():
    weights, x = _inputs(chain.CHAIN_SHAPES)
    cw = chain_weights_from_numpy(weights, "f32")
    with pytest.raises(ValueError, match="multiple of 128"):
        chain.gemm_chain(torch.from_numpy(x[:200]), cw)
    with pytest.raises(TypeError, match="float32"):
        chain.gemm_chain(torch.from_numpy(x).double(), cw)
    with pytest.raises(ValueError, match="expected"):
        chain.gemm_chain(torch.from_numpy(x[:, :900]), cw)
    with pytest.raises(ValueError, match="not 'int8'"):
        chain.gemm_chain(torch.from_numpy(x), cw, "int8")
    with pytest.raises(ValueError, match="variant"):
        chain_weights_from_numpy(weights, "fp8")
    with pytest.raises(ValueError, match="connect"):
        chain_weights_from_numpy(weights[::-1][:2] + weights[:1], "f32")


def test_benchmark_inputs_are_the_scripts_draws():
    """gfdm_tpu_torch.benchmarks.int8_gauss draws what the script's main
    draws (benchmarks/int8_gauss.py:110-118), and needs a card to run."""
    rng = np.random.default_rng(0)
    shapes = [(936, 1152), (1152, 1152), (1152, 1152)]
    weights = [rng.standard_normal(s).astype(np.float32) / np.sqrt(s[0]) for s in shapes]
    x = rng.standard_normal((256, 936)).astype(np.float32)
    w_port, x_port, scales = port_bench.make_inputs(256, 3)
    for a, b in zip(weights, w_port):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(x, x_port)
    assert scales == [np.float32(1.0 + 1e-6 * i) for i in range(3)]
    if not torch.cuda.is_available():
        assert port_bench.main(["256", "1"]) == 1


def test_chip_smoke_counts_the_wrappers_launches():
    """The launches chip_smoke.py's phase 10 holds the main path's chain
    steps to are the wrapper's own count for one call, ``chain._KERNELS``:
    f32 3, bf16 4, int8 4 (x's pass and three stages, the launches
    ``chain.INT8_LAUNCHES`` names and benchmarks/kernels.py times one by
    one); importing chip_smoke needs no card."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    assert chain._KERNELS == {"f32": 3, "bf16": 4, "int8": 4}
    assert len(chain.INT8_LAUNCHES) == chain._KERNELS["int8"]


@pytest.mark.parametrize("variant", chain.VARIANTS)
def test_cuda_scratch_plan(variant):
    """What _chain_cuda allocates besides out: f32 two float32 (B, 1152)
    planes, bf16 one bf16 (B, 1152) plane (stage 1 writes into out's
    bytes), int8 two int8 (B, 1152) planes (x's int8 copy, then the stages'
    int8 outputs) and the (3, B / 128) int32 group maxima."""
    batch = 384
    scratch, gmax = chain._chain_scratch(batch, variant, "cpu")
    if variant == "bf16":
        assert scratch.dtype == torch.bfloat16 and scratch.shape == (batch, 1152)
    elif variant == "int8":
        assert scratch.dtype == torch.int8 and scratch.shape == (2, batch, 1152)
    else:
        assert scratch.dtype == torch.float32 and scratch.shape == (2, batch, 1152)
    if variant == "int8":
        assert gmax.dtype == torch.int32 and gmax.shape == (3, batch // 128)
    else:
        assert gmax is None
