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

from hunyuanvideo_efficiency_tpu.ops import conv3d_pallas
from hunyuanvideo_efficiency_tpu.ops import conv3d as jconv
from hunyuanvideo_efficiency_tpu_torch.ops import conv3d as tconv
from hunyuanvideo_efficiency_tpu_torch.ops.conv3d_cuda import (
    conv3d_stride1, conv3d_stride1_v2, conv_applicable)

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
