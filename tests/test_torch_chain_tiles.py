"""The int8 GEMM chain's CUDA schedule (csrc/chain.cu) replayed in torch on the CPU.

The card runs the int8 chain as four launches (kernels/chain.py
``INT8_LAUNCHES``): x's pass, a cluster of 8 CTAs a 128-row
group, each holding 16 rows, quantizes x into an int8 plane whose rows are
zero-padded to a multiple of 64 bytes; then three stages over 128 x 192
tiles, 128-deep k-slabs (TMA zero-fills k past the input's width), int32
sums; stages 1 and 2 settle each group's scale across the cluster of the
group's 6 column tiles (each tile's max |acc|, scaled once: rounding is
monotonic) and store int8, stage 3 stores float32. This file replays that
arithmetic step by step and holds it to the plain version
(``chain._quantize_groups``, ``chain._int8_stage``, ``chain._chain_plain``)
and to the JAX script's own ``_chain_int8`` (``benchmarks/int8_gauss.py``,
its ``pallas_call`` in interpret mode through tests/test_torch_chain.py's
helper), all bit for bit. tests/test_torch_gpu.py holds the kernels to the
plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfdm_tpu_torch.kernels import chain
from test_torch_chain import _interpret_build

torch.set_num_threads(1)

HID, GROUP, SLAB, BN, XCL = 1152, 128, 128, 192, 8
NT = HID // BN  # column tiles of a group: the stage's cluster


def int8_pitch(d_in: int) -> int:
    """Row pitch in bytes of x's int8 copy (csrc/chain.cu Int8Call::lda): d_in
    rounded up to the weights' k padding, 64, so every TMA row is a multiple
    of 16 bytes."""
    return -(-d_in // 64) * 64


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def replay_quantize_x(x: torch.Tensor):
    """chain_quantize_kernel<false>: (B, d) float32 -> (the int8 plane at
    pitch int8_pitch(d), each group's max |x| as the kernel writes it:
    unclamped)."""
    B, d = x.shape
    G, lda = B // GROUP, int8_pitch(d)
    xs = x.reshape(G, XCL, GROUP // XCL, d)  # a CTA's 16 rows
    m = xs.abs().amax(dim=(2, 3)).amax(dim=1)  # each CTA's max, then the cluster's
    s = torch.full_like(m, 127.0) / torch.clamp(m, min=1e-20)  # __fdiv_rn
    q = torch.clamp(torch.round(xs * s[:, None, None, None]), -127, 127)
    plane = torch.full((B, lda), 0x55, dtype=torch.int8)  # the kernel writes every byte
    plane[:, :d] = q.to(torch.int8).reshape(B, d)
    plane[:, d:] = 0
    return plane, m


def replay_acc(a: torch.Tensor, kd: int, w_t: torch.Tensor) -> torch.Tensor:
    """A stage's int32 sums tile by tile: rows of a (int8, pitch >= kd) and
    rows of W^T (1152, kp) int8 in 128-deep slabs, each slab's k >= kd zero
    (TMA's fill), 128 x 192 tiles. Returns (B, 1152) int32."""
    B = a.shape[0]
    acc = torch.zeros(B, HID, dtype=torch.int32)
    for k0 in range(0, kd, SLAB):
        ka = torch.zeros(B, SLAB, dtype=torch.int32)
        kb = torch.zeros(HID, SLAB, dtype=torch.int32)
        n = min(SLAB, kd - k0)
        ka[:, :n] = a[:, k0 : k0 + n].int()
        kb[:, :n] = w_t[:, k0 : k0 + n].int()
        for m0 in range(0, B, GROUP):
            for n0 in range(0, HID, BN):
                acc[m0 : m0 + GROUP, n0 : n0 + BN] += ka[m0 : m0 + GROUP] @ kb[n0 : n0 + BN].T
    return acc


def replay_epilogue(acc: torch.Tensor, m_in: torch.Tensor, c: float, quantize: bool):
    """A stage's epilogue. out = fl(float(acc) * scale), scale = fl(c *
    max(m_in, 1e-20)). quantize (stages 1-2): each column tile's max |acc|,
    the cluster's max over the 6 tiles, mv = fl(float(max) * scale), s' =
    127 / max(mv, 1e-20), q = clip(rint(out * s')): returns (q int8, mv,
    the tiles' maxima); else the float32 out."""
    B = acc.shape[0]
    G = B // GROUP
    scale = _f32(c) * torch.clamp(m_in, min=1e-20)  # (G,) float32
    v = acc.float().reshape(G, GROUP, HID) * scale[:, None, None]
    if not quantize:
        return v.reshape(B, HID)
    tiles = acc.abs().reshape(G, GROUP, NT, BN).amax(dim=(1, 3))  # (G, 6) int32
    mv = tiles.amax(dim=1).float() * scale
    s = torch.full_like(mv, 127.0) / torch.clamp(mv, min=1e-20)
    q = torch.clamp(torch.round(v * s[:, None, None]), -127, 127)
    return q.to(torch.int8).reshape(B, HID), mv, tiles


def replay_chain(x: torch.Tensor, cw) -> torch.Tensor:
    """The four launches: x's pass, stages 1-2 quantizing in their
    epilogue, stage 3 writing float32."""
    a, m = replay_quantize_x(x)
    kd = x.shape[1]
    for s, (w_t, inv) in enumerate(zip(cw.w_t, cw.inv)):
        acc = replay_acc(a, kd, w_t)
        if s == 2:
            return replay_epilogue(acc, m, chain._dequant_const(inv), False)
        a, m, _tiles = replay_epilogue(acc, m, chain._dequant_const(inv), True)
        kd = HID
    raise AssertionError("three stages")


def _weights(d_in: int, seed: int):
    rng = np.random.default_rng(seed)
    shapes = [(d_in, HID), (HID, HID), (HID, HID)]
    return [rng.standard_normal(s).astype(np.float32) / np.sqrt(s[0]) for s in shapes]


def _x(batch: int, d_in: int, seed: int, gains=(1.0, 10.0)) -> torch.Tensor:
    x = np.random.default_rng(seed + 1).standard_normal((batch, d_in)).astype(np.float32)
    x *= np.repeat(np.resize(np.asarray(gains, np.float32), batch // GROUP), GROUP)[:, None]
    return torch.from_numpy(x)


@pytest.mark.parametrize("d_in", [8, 936, 1152])
def test_quantize_x_pass(d_in):
    """x's pass: the cluster's max over its CTAs' maxima is the group's;
    the values equal _quantize_groups'; the pad bytes are zero."""
    x = _x(256, d_in, d_in, gains=(0.01, 3.0))
    plane, m = replay_quantize_x(x)
    q_ref, m_ref = chain._quantize_groups(x)
    lda = int8_pitch(d_in)
    assert lda % 64 == 0 and d_in <= lda < d_in + 64
    assert torch.equal(torch.clamp(m, min=1e-20), m_ref.reshape(-1))
    assert torch.equal(plane[:, :d_in].double(), q_ref.reshape(256, d_in))
    assert not plane[:, d_in:].any()


@pytest.mark.parametrize("d_in", [8, 936, 1152])
def test_slab_products_are_exact(d_in):
    """The int32 sums over 128-deep slabs, the last one zero-filled past
    d_in, equal the plain version's float64 product of the same values."""
    x = _x(256, d_in, d_in)
    cw = chain.chain_weights_from_numpy(_weights(d_in, d_in), "int8")
    plane, _m = replay_quantize_x(x)
    acc = replay_acc(plane, d_in, cw.w_t[0])
    q_ref, _ = chain._quantize_groups(x)
    ref = torch.matmul(q_ref.reshape(256, d_in), cw.w[0].double())
    assert acc.dtype == torch.int32 and torch.equal(acc.double(), ref)
    assert int(acc.abs().max()) < 2**31


@pytest.mark.parametrize("gains", [(1.0, 10.0), (1e-3, 1.0, 0.0)], ids=["loud", "zero"])
def test_cluster_epilogue_matches_plain(gains):
    """Stage 1's epilogue: the max over the 6 column tiles' maxima is the
    group's, its scaled value is max |out| of the plain stage output, and
    the int8 values equal _quantize_groups of that output, bit for bit."""
    batch = GROUP * len(gains)
    x = _x(batch, 936, 7, gains)
    cw = chain.chain_weights_from_numpy(_weights(936, 7), "int8")
    c = chain._dequant_const(cw.inv[0])
    plane, m = replay_quantize_x(x)
    acc = replay_acc(plane, 936, cw.w_t[0])
    q, mv, tiles = replay_epilogue(acc, m, c, True)
    out = chain._int8_stage(x, cw.w[0], cw.inv[0])  # the plain stage output
    G = batch // GROUP
    assert torch.equal(tiles.amax(dim=1), acc.abs().reshape(G, -1).amax(dim=1))
    assert torch.equal(mv, out.abs().reshape(G, -1).amax(dim=1))
    q_ref, m_ref = chain._quantize_groups(out)
    assert torch.equal(torch.clamp(mv, min=1e-20), m_ref.reshape(-1))
    assert torch.equal(q.double().reshape(G, GROUP, HID), q_ref)
    assert torch.equal(replay_epilogue(acc, m, c, False), out)


def test_tile_max_identity():
    """max |fl(float(a) * s)| = fl(float(max |a|) * s) for s > 0: int32
    values around float32's rounding steps (2^24 and past it), signs
    mixed, and scales from 1e-30 to 1e10."""
    rng = np.random.default_rng(3)
    base = np.array([2**24 - 1, 2**24, 2**24 + 1, 2**24 + 3, 18_580_608, 1, 0], np.int64)
    vals = np.concatenate([base, -base, rng.integers(-(2**25), 2**25, 5000)])
    a = torch.from_numpy(vals.astype(np.int32))
    for s in (1e-30, 3.3e-7, 0.7, 1.0, 1.7e3, 1e10):
        sc = _f32(s)
        direct = (a.float() * sc).abs().max()
        assert torch.equal(direct, a.abs().max().float() * sc)


def test_all_zero_group():
    """A group of zeros: m clamps to 1e-20, s = 1.27e22 is finite, every q
    and every later stage's output in that group is 0; the other group
    is untouched by it."""
    x = _x(256, 936, 11)
    x[:GROUP] = 0.0
    cw = chain.chain_weights_from_numpy(_weights(936, 11), "int8")
    plane, m = replay_quantize_x(x)
    assert float(m[0]) == 0.0 and not plane[:GROUP].any()
    got = replay_chain(x, cw)
    assert torch.equal(got, chain._chain_plain(x, cw))
    assert not got[:GROUP].any() and bool(torch.isfinite(got).all())
    assert torch.equal(got[GROUP:], chain._chain_plain(x[GROUP:], cw))


@pytest.mark.parametrize("col", [BN - 1, BN, HID - 1], ids=["tile_end", "tile_start", "last"])
def test_huge_value_on_a_tile_boundary(col):
    """One stage-1 output 1e4 times the rest sits at a column-tile edge:
    only that tile's max carries it, and the cluster's max still reaches
    every tile's quantization (the rest of the group rounds to 0 or ±1)."""
    x = _x(128, 1152, 5)
    cw = chain.chain_weights_from_numpy(_weights(1152, 5), "int8")
    # make column `col` of stage 1's output huge: x along that weight column
    w1 = cw.w[0][:, col].float()
    x = x * 1e-4 + w1[None, :] / float(w1.abs().max())
    plane, m = replay_quantize_x(x)
    acc = replay_acc(plane, 1152, cw.w_t[0])
    q, mv, tiles = replay_epilogue(acc, m, chain._dequant_const(cw.inv[0]), True)
    hot = col // BN
    assert int(tiles[0].argmax()) == hot and int(acc[:, col].abs().max()) == int(tiles[0, hot])
    out = chain._int8_stage(x, cw.w[0], cw.inv[0])
    q_ref, _m = chain._quantize_groups(out)
    assert torch.equal(q.double().reshape(1, GROUP, HID), q_ref)
    assert int(q[:, col].abs().max()) == 127


def test_half_way_values_round_to_even():
    """Values at x s = k + 0.5 exactly: rint rounds half to even (0.5 -> 0,
    1.5 -> 2, 2.5 -> 2, -2.5 -> -2), as torch.round and the JAX script."""
    k = np.arange(-126, 126, dtype=np.float32) + np.float32(0.5)
    row = np.concatenate([k, [127.0], np.zeros(936 - len(k) - 1, np.float32)])
    x = torch.from_numpy(np.tile(row.astype(np.float32), (128, 1)))  # m = 127: s = 1
    plane, m = replay_quantize_x(x)
    assert float(m[0]) == 127.0
    expect = np.round(k).astype(np.int8)  # numpy rounds half to even
    assert np.array_equal(plane[0, : len(k)].numpy(), expect)
    assert plane[0, : len(k)].tolist()[125:128] == [0, 0, 2]  # -0.5, 0.5, 1.5
    q_ref, _ = chain._quantize_groups(x)
    assert torch.equal(plane[:, :936].double(), q_ref.reshape(128, 936))


def test_launch_counts_are_the_schedules():
    """One int8 call: four launches (x's pass, three stages), the wrapper's
    count, in the order csrc/chain.cu int8_launch makes them."""
    assert chain._KERNELS["int8"] == len(chain.INT8_LAUNCHES) == 4
    assert chain.INT8_LAUNCHES == ("quantize_x", "stage1", "stage2", "stage3")


@pytest.mark.parametrize("batch", [128, 384])
def test_scratch_holds_the_schedule(batch):
    """Plane 0 holds x's copy at its pitch (at most 1152 bytes a row), then
    stage 2's output; plane 1 stage 1's; gmax one row a stage's input."""
    scratch, gmax = chain._chain_scratch(batch, "int8", "cpu")
    assert scratch.shape == (2, batch, HID) and scratch.dtype == torch.int8
    assert all(int8_pitch(d) <= HID for d in (8, 936, 1152))
    assert gmax.shape == (3, batch // GROUP) and gmax.dtype == torch.int32


@pytest.mark.parametrize("d_in", [936, 8])
def test_replay_matches_plain_and_the_script(monkeypatch, d_in):
    """The whole replayed schedule against the plain chain and the JAX
    script's _chain_int8 (its build, interpret mode), bit for bit, at B =
    256 with the second group 10 times louder."""
    weights = _weights(d_in, 2)
    x = _x(256, d_in, 2)
    cw = chain.chain_weights_from_numpy(weights, "int8")
    got = replay_chain(x, cw)
    assert torch.equal(got, chain._chain_plain(x, cw))
    shapes = [w.shape for w in weights]
    fn, _seen = _interpret_build(monkeypatch, "int8", 256, shapes, weights)
    ref = np.asarray(fn(jnp.asarray(x.numpy()), np.float32(1.0)))
    np.testing.assert_array_equal(got.numpy(), ref)
