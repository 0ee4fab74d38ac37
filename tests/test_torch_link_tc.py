"""The staged tensor-core link (csrc/link.cu) on the CPU: its arithmetic,
host layouts and launch plan, without a card.

The kernels run the float32 Gauss stacks as 3xTF32 tensor-core products
(operands split into hi = tf32(x) and lo = tf32(x - hi), lo*hi + hi*lo +
hi*hi summed in float32). Here that product is emulated exactly
(tests/tf32_emulation.py: the tensor cores form each TF32 x TF32 product
exactly)
and run over the whole plain link in place of every float32-stack product:
the link's data stays within 1e-5 of the float32 plain version and within
the JAX package's limit of its Pallas kernel, and each stage's product
within 1e-6 of its float64 product's largest magnitude, or at float32's own
error where a long float32 sum costs float32 more. tests/test_torch_gpu.py
holds the kernels themselves against the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdm_tpu import GfdmConfig as JaxConfig
from gfdm_tpu.kernels import fused as jax_fused
from gfdm_tpu_torch import GfdmConfig
from gfdm_tpu_torch.entry import large_k_config, planar_payload
from gfdm_tpu_torch.kernels import fused
from tf32_emulation import gdot_3xtf32, mm_3xtf32, tf32, tf32_split

torch.set_num_threads(1)

B = 64
K32 = dict(subcarriers=32, active_subcarriers=24, timeslots=5, cp_len=8, cs_len=4)


def _cfg(K):
    return GfdmConfig() if K == 64 else large_k_config(K)


def _emulated(monkeypatch):
    """Patch the plain link's products to 3xTF32; returns the list that
    collects each float32-stack product's inputs, and the float32 product."""
    plain, calls = fused._gdot, []

    def gdot(xr, xi, g, n_in):
        if g.dtype == torch.bfloat16:
            return plain(xr, xi, g, n_in)
        calls.append((xr, xi, g, n_in))
        return gdot_3xtf32(xr, xi, g, n_in)

    monkeypatch.setattr(fused, "_gdot", gdot)
    return calls, plain


def test_tf32_rounds_to_nearest_ties_away():
    """tf32 keeps 10 mantissa bits, rounding half away from zero (cvt.rna)."""
    ulp = 2.0**-10
    x = torch.tensor([1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0**-23, -(1.0 + ulp / 2),
                      1.0 + 1.5 * ulp, 3.0e-3, -7.25], dtype=torch.float32)
    got = tf32(x).tolist()
    assert got[:4] == [1.0 + ulp, 1.0, -(1.0 + ulp), 1.0 + 2 * ulp]
    assert got[5] == -7.25
    bits = tf32(torch.from_numpy(
        np.random.default_rng(0).standard_normal(4096).astype(np.float32))).view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0


def test_tf32_split_error_is_float32_level():
    """hi + lo recovers x to 2^-22 relative; lo*hi + hi*lo + hi*hi a product
    to about 1e-7, where one-pass TF32 is off by ~5e-4."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(8192) * 10.0 ** rng.uniform(-6, 6, 8192))
                         .astype(np.float32))
    hi, lo = tf32_split(x)
    rel = ((hi.double() + lo.double() - x.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2.0**-22
    a = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32))
    ref = a.double() @ b.double()
    scale = float(ref.abs().max())
    assert float((mm_3xtf32(a, b).double() - ref).abs().max()) / scale < 1e-6
    one_pass = float((tf32(a) @ tf32(b) - ref).abs().max()) / scale
    assert one_pass > 1e-4


@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
@pytest.mark.parametrize("K", [64, 128])
def test_link_with_3xtf32_products_matches_plain(K, ic_mode, monkeypatch):
    cfg = _cfg(K)
    data = torch.from_numpy(planar_payload(cfg, B, seed=K)).reshape(B, -1)
    ref, _met = fused._link_single_plain(cfg, data, 2, ic_mode)
    calls, plain = _emulated(monkeypatch)
    got, _met = fused._link_single_plain(cfg, data, 2, ic_mode)
    # Tx, estimate, preamble DFT, block DFT, demod: the five float32 stacks
    assert len(calls) == 5
    assert float((got - ref).abs().max()) <= 1e-5
    for xr, xi, g, n_in in calls:
        g64, xr64, xi64 = g.double(), xr.double(), xi.double()
        rr = xr64 @ g64[:n_in] - xi64 @ g64[n_in : 2 * n_in]
        ri = xr64 @ g64[n_in : 2 * n_in] + xi64 @ g64[:n_in]
        scale = max(float(rr.abs().max()), float(ri.abs().max()))

        def err(y):
            return max(float((y[0].double() - rr).abs().max()),
                       float((y[1].double() - ri).abs().max()))

        # float32 sums of up to 3,456 terms cost float32 itself ~1e-6 here
        # (1.01e-6 for the K = 128 Tx): 3xTF32 stays at that level
        limit = max(1e-6 * scale, 1.5 * err(plain(xr, xi, g, n_in)))
        assert err(gdot_3xtf32(xr, xi, g, n_in)) <= limit, g.shape


def test_link_with_3xtf32_products_matches_pallas(monkeypatch):
    """The slice against the JAX package: the 3xTF32 link against the
    Pallas link kernel in interpret mode (B = 8, block 4), as
    tests/test_torch_fused.py holds the plain version."""
    jc, tc = JaxConfig(), GfdmConfig()
    data = planar_payload(tc, 8, seed=31)
    d_ref, _snr, evm_ref = jax_fused.link_single_fused(jc, jnp.asarray(data), ic_iterations=2,
                                                       block=4, ic_mode="matmul")
    _emulated(monkeypatch)
    d_got, _snr, evm_got = fused.link_single_fused(tc, torch.from_numpy(data),
                                                   ic_mode="matmul")
    np.testing.assert_allclose(d_got.numpy(), np.asarray(d_ref), atol=1e-4)
    assert abs(float(evm_got) - float(evm_ref)) < 1e-4


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
@pytest.mark.parametrize("name", ["canonical", "k32m5"])
def test_link_operands_are_the_host_stacks_unpadded(name, ic_mode, dtype_name):
    """The kernels read the host's Gauss stacks as built (the same tensors,
    no padded copy or new layout): they zero-fill ragged slabs in the copy.
    Each stack row is a whole number of the 16-byte copies."""
    cfg = GfdmConfig(**({} if name == "canonical" else K32))
    opts = fused._rx_options(2, ic_mode)
    ops = fused._link_operands(cfg, "cpu", opts, dtype_name)
    stacks = fused._stacks(cfg, "cpu", dtype_name)
    for key, stack in (("t_g", "T_G"), ("e_g", "E_G"), ("f_g", "F_G"), ("bfd_g", "Bfd_G"),
                       ("f2_g", "F2_G")):
        assert ops[key] is stacks[stack]
    n, nd, half = cfg.block_len, cfg.n_data_symbols, 2 * cfg.subcarriers
    shapes = {"t_g": (3 * nd, n), "e_g": (3 * half, n), "f_g": (3 * n, n),
              "bfd_g": (3 * n, n), "f2_g": (3 * half, half)}
    if ic_mode == "matmul":
        assert ops["icop"] is fused._ic_operand(cfg, "matmul", "cpu", opts.amp)
        shapes["icop"] = (3 * n, n)
    for key, shape in shapes.items():
        t = ops[key]
        assert tuple(t.shape) == shape and t.is_contiguous()
        assert (shape[1] * t.element_size()) % 16 == 0


@pytest.mark.parametrize("K", [64, 128, 256, 512])
def test_link_configs_fit_the_16_byte_copies(K):
    """Every config the link runs: each stack row (N or 2K wide) is a whole
    number of 16-byte copies in float32 and bf16, and the activations' rows
    (payload, preamble window, N-wide stages) start 16-byte aligned."""
    cfg = _cfg(K)
    for width in (cfg.block_len, 2 * cfg.subcarriers):
        assert width % 8 == 0
    for offset in (cfg.n_data_symbols, cfg.cp_len, cfg.preamble_len, cfg.block_len):
        assert offset % 4 == 0


@pytest.mark.parametrize("name", ["canonical", "k32m5", "k128"])
def test_inverse_demap_scatter_equals_the_gather(name):
    """The link's last stage scatters each frame position through the
    inverse demap; that equals the plain version's gather bit for bit."""
    cfg = {"canonical": GfdmConfig(), "k32m5": GfdmConfig(**K32),
           "k128": large_k_config(128)}[name]
    n = cfg.block_len
    idx = fused._kernel_consts(cfg, "cpu")["demap_idx"].long()
    inv = fused._inv_demap(cfg, "cpu").long()
    assert inv.shape == (n,) and int((inv >= 0).sum()) == cfg.n_data_symbols
    sym = torch.from_numpy(np.random.default_rng(3).standard_normal((4, n)).astype(np.float32))
    out = torch.zeros(4, cfg.n_data_symbols)
    keep = inv >= 0
    out[:, inv[keep]] = sym[:, keep]
    assert torch.equal(out, sym[:, idx])


@pytest.mark.parametrize("ic_iterations", [0, 1, 2, 3])
@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
def test_link_launch_plan(ic_mode, ic_iterations):
    """One launch a stage: Tx, estimate + DFT + ZF, preamble DFT, metrics,
    demod, then one an IC iteration. The CPU path launches nothing."""
    n = fused.link_launches(ic_mode, ic_iterations)
    assert n == 5 + ic_iterations
    plan = fused._link_plan(ic_iterations)
    assert len(plan) == n
    assert [p[0] for p in plan] == list(fused.LINK_STAGES) + ["ic"] * ic_iterations
    assert [p[1] for p in plan] == list(range(5)) + [5] * ic_iterations
    assert [p[2] for p in plan[5:]] == list(range(ic_iterations))
    cfg = GfdmConfig()
    before = dict(fused.LAUNCHES)
    data = torch.from_numpy(planar_payload(cfg, 3, seed=5))
    d_hat, _snr, _evm = fused.link_single_fused(cfg, data, ic_iterations=ic_iterations,
                                                ic_mode=ic_mode)
    assert d_hat.shape == data.shape and fused.LAUNCHES == before


def test_link_refuses_k1024_before_building_constants():
    """K = 1024 (N = 9216) would need 1 GB float32 stacks: the wrapper raises
    at once, naming the factored link, and builds nothing; K = 512 passes."""
    cfg = large_k_config(1024)
    with pytest.raises(ValueError, match="link_step_factored"):
        fused.link_single_fused(cfg, torch.zeros(2, 2, cfg.n_data_symbols))
    assert not any(key[0] == cfg for key in fused._KERNEL_CONSTS)
    assert not any(key[0] == cfg for key in fused._EXTRA_CONSTS)
    fused._check_dense_size(large_k_config(512), "link_single_fused", "link_step_factored")


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_gdot64_is_the_gauss_product_summed_in_float64(dtype_name):
    """_gdot64 rounds the activations as _gdot does (bf16 stacks: xr, xi and
    their bf16 sum plane), sums in float64 and rounds once to float32."""
    cfg = GfdmConfig()
    n = cfg.block_len
    g = fused._stacks(cfg, "cpu", dtype_name)["F_G"]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((8, 2 * n)).astype(np.float32))
    xr, xi = x[:, :n], x[:, n:]
    if dtype_name == "bfloat16":
        xr, xi = xr.bfloat16(), xi.bfloat16()
    s = (xr + xi).double()
    xr, xi, g64 = xr.double(), xi.double(), g.double()
    p1, p2 = xr @ g64[:n], xi @ g64[n : 2 * n]
    want = ((p1 - p2).float(), (s @ g64[2 * n :] - p1 - p2).float())
    got = fused._gdot64(x[:, :n], x[:, n:], g, n)
    assert all(a.dtype == torch.float32 and torch.equal(a, b) for a, b in zip(got, want))
    near = torch.cat(fused._gdot(x[:, :n], x[:, n:], g, n), 1)
    assert float((torch.cat(got, 1) - near).abs().max()) <= 1e-5 * float(near.abs().max())


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("ic_mode", ["conv", "matmul"])
def test_link_plain_summed_in_float64_matches_plain(ic_mode, dtype_name):
    """The plain link with every product summed in float64 (sum64, what the
    bf16 link kernels are held to on the card) against the float32 plain
    version: float32 stacks 1e-5; bf16 stacks 1e-2 a burst (activations on
    either side of a bf16 rounding boundary), EVM within 1e-4."""
    cfg = GfdmConfig()
    data = torch.from_numpy(planar_payload(cfg, B, seed=7)).reshape(B, -1)
    kw = dict(dtype_name=dtype_name)
    ref, _met = fused._link_single_plain(cfg, data, 2, ic_mode, **kw)
    got, _met = fused._link_single_plain(cfg, data, 2, ic_mode, sum64=True, **kw)
    assert float((got - ref).abs().max()) <= (1e-5 if dtype_name == "float32" else 1e-2)

    def evm(x):
        return float(((x - data) ** 2).sum() / (data**2).sum()) ** 0.5

    assert abs(evm(got) - evm(ref)) < 1e-4 and evm(got) < 0.025


@pytest.mark.parametrize("name", ["canonical", "k32m5", "k128"])
def test_tx_stage_preamble_window_is_the_framed_bursts(name):
    """The Tx stage writes each burst's preamble window P[b, q 2K + j] =
    pre[q, cp + j] (csrc/link.cu tx_stage); that is the window the plain
    receiver reads from the framed burst, columns cp .. cp + 2K a plane."""
    cfg = {"canonical": GfdmConfig(), "k32m5": GfdmConfig(**K32),
           "k128": large_k_config(128)}[name]
    half, cp, L, lp = 2 * cfg.subcarriers, cfg.cp_len, cfg.frame_len, cfg.preamble_len
    pre = fused._link_operands(cfg, "cpu", fused._rx_options(2, "conv"), "float32")["pre"]
    flat = pre.reshape(-1)
    j = torch.arange(2 * half)
    q = j // half
    window = flat[q * lp + cp + j - q * half]
    bursts = fused._tx_frame_plain(cfg, torch.from_numpy(planar_payload(cfg, 3, seed=2))
                                   .reshape(3, -1))
    for b in range(3):
        assert torch.equal(window, torch.cat([bursts[b, cp : cp + half],
                                              bursts[b, L + cp : L + cp + half]]))
