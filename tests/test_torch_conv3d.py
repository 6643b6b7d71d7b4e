"""The port's causal conv3d (K3, the temporal-reuse kernel B11 and the
F.conv3d path) and temporal resampling ops against the JAX package, on the
CPU.

With conv3d_pallas.INTERPRET_OVERRIDE the JAX causal_conv3d routes gated
shapes (Cin = Cout = 128, H % 8 == 0) through its Pallas kernel in
interpret mode; the port's wrappers run their plain version on CPU tensors.
fp32 inputs from numpy; tolerance 2e-4 (27*128-term fp32 sums).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.ops import conv3d_pallas
from hunyuanvideo_efficiency_tpu.ops import conv3d as jconv
from hunyuanvideo_efficiency_tpu_torch.ops import conv3d as tconv
from hunyuanvideo_efficiency_tpu_torch.ops.conv3d_cuda import (
    TILE_WIDTHS, conv3d_stride1, conv3d_stride1_v2, conv_applicable,
    conv_block_n, conv_tile)
from hunyuanvideo_efficiency_tpu_torch.probes import conv_probe

TOL = 2e-4


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("w", [11, 16])
def test_gated_conv_matches_jax_pallas(monkeypatch, w):
    monkeypatch.setattr(conv3d_pallas, "INTERPRET_OVERRIDE", True)
    rng = np.random.default_rng(0)
    x = _rand(rng, 1, 4, 8, w, 128)
    kern = _rand(rng, 3, 3, 3, 128, 128, scale=0.05)
    bias = _rand(rng, 128)
    assert conv3d_pallas.pallas_conv_applicable(x.shape, kern.shape,
                                                (1, 1, 1))
    assert conv_applicable(kern.shape, (1, 1, 1))
    ref = jconv.causal_conv3d(jnp.asarray(x), jnp.asarray(kern),
                              jnp.asarray(bias))
    before = conv3d_stride1.LAUNCHES
    out = tconv.causal_conv3d(torch.from_numpy(x), torch.from_numpy(kern),
                              torch.from_numpy(bias))
    assert conv3d_stride1.LAUNCHES == before   # CPU: plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("w", [13, 16])
@pytest.mark.parametrize("cout", [128, 256])
def test_conv_v2_matches_jax_pallas_v2(w, cout):
    """B11's wrapper against JAX's conv3d_stride1_pallas_v2 (interpret
    mode) at the shapes of tests/test_conv_pallas.py: T = 5 > kt, so the
    JAX kernel's slots wrap, and two 8-row H blocks. JAX's input is
    over-padded on the right to 8-aligned widths; its extra columns are
    cropped."""
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 5, 16, w, 128)
    kern = _rand(rng, 3, 3, 3, 128, cout, scale=0.05)
    w_out = -(-w // 8) * 8
    extra = -(-(w_out + 2) // 8) * 8 - (w + 2)
    xp = np.pad(x, [(0, 0), (2, 0), (1, 1), (1, 1 + extra), (0, 0)],
                mode="edge")
    ref = np.asarray(conv3d_pallas.conv3d_stride1_pallas_v2(
        jnp.asarray(xp), jnp.asarray(kern), w_out,
        interpret=True))[:, :, :, :w]
    before = conv3d_stride1_v2.LAUNCHES
    out = conv3d_stride1_v2(torch.from_numpy(xp[:, :, :, :w + 2]),
                            torch.from_numpy(kern))
    assert conv3d_stride1_v2.LAUNCHES == before   # CPU: plain version
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["auto", "cuda", "3d"])
def test_causal_conv3d_impl_matches_jax(monkeypatch, impl):
    """Each impl against JAX's causal_conv3d with the same impl ("cuda" is
    the port's name of JAX's "pallas"), a gated shape with a bias."""
    monkeypatch.setattr(conv3d_pallas, "INTERPRET_OVERRIDE", True)
    rng = np.random.default_rng(5)
    x = _rand(rng, 1, 4, 8, 11, 128)
    kern = _rand(rng, 3, 3, 3, 128, 128, scale=0.05)
    bias = _rand(rng, 128)
    ref = jconv.causal_conv3d(jnp.asarray(x), jnp.asarray(kern),
                              jnp.asarray(bias),
                              impl="pallas" if impl == "cuda" else impl)
    out = tconv.causal_conv3d(torch.from_numpy(x), torch.from_numpy(kern),
                              torch.from_numpy(bias), impl=impl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("impl,cin", [("cuda", 64), ("pallas", 128),
                                      ("t2d", 128)])
def test_causal_conv3d_impl_rejects(impl, cin):
    """"cuda" outside the K3 gate raises, as JAX's "pallas" does; JAX's
    names "pallas" and "t2d" (an XLA:TPU layout) are not impls of the
    port."""
    x = torch.zeros(1, 2, 8, 8, cin)
    kern = torch.zeros(3, 3, 3, cin, 128)
    with pytest.raises(ValueError, match="gate" if cin == 64 else "impl"):
        tconv.causal_conv3d(x, kern, impl=impl)


@pytest.mark.parametrize("dtype,impl,k3", [
    (torch.float32, "auto", False),    # fp32 inside the gate: F.conv3d
    (torch.bfloat16, "auto", True),
    (torch.float16, "auto", True),
    (torch.float32, "cuda", True),     # "cuda" keeps K3, which rejects fp32
                                       # on the card (test_torch_cuda_kernels)
    (torch.float32, "3d", False),
])
def test_causal_conv3d_routes_by_dtype(monkeypatch, dtype, impl, k3):
    """Inside the K3 gate, "auto" takes K3 only for the types K3 takes and
    F.conv3d for fp32 (what the reference runs in fp32); both routes give
    the plain conv's result."""
    calls = []

    def k3_spy(xp, kernel, bias=None):
        calls.append(xp.dtype)
        return conv3d_stride1(xp, kernel, bias)

    monkeypatch.setattr(tconv, "conv3d_stride1", k3_spy)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(_rand(rng, 1, 3, 8, 8, 128)).to(dtype)
    kern = torch.from_numpy(_rand(rng, 3, 3, 3, 128, 128, scale=0.05))
    out = tconv.causal_conv3d(x, kern, impl=impl)
    assert calls == ([dtype] if k3 else [])
    assert out.dtype == dtype and out.shape == (1, 3, 8, 8, 128)
    xp = tconv.replicate_pad(x.float(), (2, 0), (1, 1), (1, 1))
    ref = conv3d_stride1(xp, kern)
    tol = TOL if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("cin,cout,k,stride", [
    (32, 64, 3, (1, 1, 1)),      # below the channel gate
    (16, 128, 3, (1, 1, 1)),     # conv_in-like
    (64, 64, 3, (2, 2, 2)),      # stride-2 downsampler
    (32, 64, 1, (1, 1, 1)),      # 1x1x1 shortcut
])
def test_ungated_conv_matches_jax(cin, cout, k, stride):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 5, 6, 7, cin)
    kern = _rand(rng, k, k, k, cin, cout, scale=0.1)
    bias = _rand(rng, cout)
    assert not conv_applicable(kern.shape, stride)
    ref = jconv.causal_conv3d(jnp.asarray(x), jnp.asarray(kern),
                              jnp.asarray(bias), stride=stride)
    out = tconv.causal_conv3d(torch.from_numpy(x), torch.from_numpy(kern),
                              torch.from_numpy(bias), stride=stride)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("factor", [(1, 2, 2), (2, 2, 2), (2, 1, 1)])
@pytest.mark.parametrize("t", [1, 3])
def test_upsample_nearest_causal_matches_jax(factor, t):
    x = _rand(np.random.default_rng(2), 1, t, 3, 4, 5)
    ref = jconv.upsample_nearest_causal_3d(jnp.asarray(x), factor)
    out = tconv.upsample_nearest_causal_3d(torch.from_numpy(x), factor)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_pool_interp_pointwise_match_jax():
    rng = np.random.default_rng(3)
    x = _rand(rng, 1, 5, 3, 4, 8)
    np.testing.assert_allclose(
        tconv.causal_avg_pool_t(torch.from_numpy(x), 2, 2).numpy(),
        np.asarray(jconv.causal_avg_pool_t(jnp.asarray(x), 2, 2)), atol=1e-6)
    np.testing.assert_array_equal(
        tconv.interpolate_nearest_t(torch.from_numpy(x), 2).numpy(),
        np.asarray(jconv.interpolate_nearest_t(jnp.asarray(x), 2)))
    kern, bias = _rand(rng, 8, 6), _rand(rng, 6)
    np.testing.assert_allclose(
        tconv.conv3d_1x1(torch.from_numpy(x), torch.from_numpy(kern),
                         torch.from_numpy(bias)).numpy(),
        np.asarray(jconv.conv3d_1x1(jnp.asarray(x), jnp.asarray(kern),
                                    jnp.asarray(bias))), atol=1e-5)


def test_gate():
    assert conv_applicable((3, 3, 3, 512, 256), (1, 1, 1))
    assert not conv_applicable((3, 3, 3, 512, 3), (1, 1, 1))
    assert not conv_applicable((3, 3, 3, 128, 128), (2, 2, 2))
    assert not conv_applicable((1, 1, 1, 128, 128), (1, 1, 1))


# (H, W) of an output frame -> the width of the kernels' 256-pixel tile:
# the conv probe's stages, chip_smoke's check_conv stages, every frame size
# of the 256x448x33 decode, and ragged frames of the CUDA tests.
CONV_TILES = {
    (256, 256): 16, (128, 128): 16, (64, 64): 16, (32, 32): 16,
    (8, 8): 16, (8, 32): 32, (32, 8): 8, (16, 16): 16, (16, 64): 16,
    (64, 16): 16, (32, 128): 16, (128, 32): 16, (64, 256): 16,
    (256, 64): 16, (17, 33): 8, (20, 6): 8, (5, 7): 16, (13, 21): 16,
    (17, 9): 16, (9, 9): 16, (8, 16): 16,
}


@pytest.mark.parametrize("hw,bw", sorted(CONV_TILES.items()))
def test_conv_tile_pins(hw, bw):
    """The host's tile pick at the decoder's and the tests' frame sizes: the
    width whose 256-pixel tiles cover the fewest pixels past the edges, 16
    on a tie."""
    assert conv_tile(*hw) == bw
    h, w = hw
    covered = {b: -(-h // (256 // b)) * (256 // b) * -(-w // b) * b
               for b in TILE_WIDTHS}
    assert covered[bw] == min(covered.values())


def test_conv_tile_covers_probe_and_decode_shapes():
    """Every frame size the conv probe and the 256x448x33 decode give K3
    is pinned above."""
    sizes = {(h, w) for _, h, w, _, _ in conv_probe.SHAPES}
    sizes |= {(h, w) for _, _, h, w, _, _ in
              conv_probe.decode_k3_shapes(256, 448, 33)}
    assert sizes <= set(CONV_TILES)


@pytest.mark.parametrize("size,launches,distinct,largest", [
    ((256, 448, 33), 186, 32, ((1, 33, 256, 256, 128, 128), 10)),
    ((544, 960, 65), 930, 64, ((1, 65, 256, 256, 128, 128), 40)),
])
def test_decode_k3_shapes(size, launches, distinct, largest):
    """K3's launches in one tiled decode, by shape (the decoder on meta
    tensors): the counts the smoke's main paths check exactly."""
    shapes = conv_probe.decode_k3_shapes(*size)
    assert sum(shapes.values()) == launches
    assert len(shapes) == distinct
    shape, n = largest
    assert shapes[shape] == n
    assert all(conv_applicable((3, 3, 3, cin, cout), (1, 1, 1))
               for _, _, _, _, cin, cout in shapes)
    assert tconv.conv3d_stride1 is conv3d_stride1   # the recorder is gone


# [B, T, H, W] x Cout -> K3's output channels a block on a 132-SM H100:
# 64 where the grid is 144 blocks of 128 channels or fewer (the decoder's
# short stages, chip_smoke's check_conv stages at 9 frames), 128 elsewhere
# (the conv probe's stages and the decode's large ones).
CONV_BLOCK_N = {
    (1, 9, 8, 8, 512): 64, (1, 9, 8, 32, 512): 64, (1, 9, 16, 16, 512): 64,
    (1, 9, 32, 32, 512): 64, (1, 9, 16, 64, 512): 64,
    (1, 17, 32, 32, 256): 64, (1, 17, 32, 32, 512): 128,
    (1, 9, 64, 64, 512): 128, (1, 9, 64, 64, 128): 64,
    (1, 17, 128, 128, 512): 128, (1, 33, 64, 64, 128): 128,
    (1, 33, 256, 256, 128): 128, (1, 33, 256, 256, 256): 128,
    (1, 61, 256, 256, 128): 128, (1, 31, 128, 128, 256): 128,
    (1, 16, 64, 64, 512): 128,
}


@pytest.mark.parametrize("shape,bn", sorted(CONV_BLOCK_N.items()))
def test_conv_block_n_pins(shape, bn):
    """The host's block-width pick: 64 only where the last wave's fill
    gains a fifth, 128 on a tie."""
    assert conv_block_n(*shape) == bn
    assert conv_block_n(*shape, sms=132) == bn


def test_conv_block_n_on_a_larger_card():
    """More SMs leave the 32 x 32 x 9 stage's 144 blocks in one wave."""
    assert conv_block_n(1, 9, 32, 32, 512, sms=144) == 128
