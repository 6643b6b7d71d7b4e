"""The port's W8A8 linear (ops/int8_matmul.py, kernel B9) against the JAX
package's on the CPU: the XLA body `models/dit._int8_linear_body` and the
Pallas kernel `ops/int8_matmul.int8_linear_pallas` in interpret mode, on
the same bf16 activations and int8 weights (h = n = 256), ragged rows, with
and without bias, gelu_tanh fused into the epilogue (Pallas) and applied to
the stored output (XLA body).

Tolerance: one bf16 rounding of the output, 1e-2 relative to its scale
(the int8 codes and the exact s32 sums agree; the fp32 epilogue may round
once more or less in XLA's fused order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunyuanvideo_efficiency_tpu.models.dit import _int8_linear_body
from hunyuanvideo_efficiency_tpu.ops.int8_matmul import (_EPILOGUE_ACTS,
                                                         int8_linear_pallas)
from hunyuanvideo_efficiency_tpu.ops.quantization import quantize_tensor_int8
from hunyuanvideo_efficiency_tpu_torch.models.dit import ACT
from hunyuanvideo_efficiency_tpu_torch.ops.int8_matmul import (
    EPILOGUE_ACTS, quantize_rows, w8a8_linear, w8a8_linear_plain)

H = N = 256


def _operands(rows, bias, seed=0):
    """JAX params {'kernel' s8 [h, n], 'scale_out', 'bias'?}, bf16 x [rows,
    h] as numpy, and the port's (x, weight [n, h], scale_out [n], bias)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((H, N)).astype(np.float32) * 0.05
    x = (rng.standard_normal((rows, H)) * 2).astype(np.float32)
    x[0, 3] = 9.0                                   # an outlier token
    p = dict(quantize_tensor_int8(jnp.asarray(w)))
    if bias:
        p["bias"] = jnp.asarray(rng.standard_normal(N).astype(np.float32),
                                jnp.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    wt = torch.from_numpy(np.asarray(p["kernel"]).T.copy())
    so = torch.from_numpy(np.array(p["scale_out"]).reshape(-1))
    bt = (torch.from_numpy(np.array(p["bias"].astype(jnp.float32)))
          .bfloat16() if bias else None)
    return p, xj, (xt, wt, so, bt)


def _close(out, ref):
    ref = np.asarray(ref.astype(jnp.float32))
    got = out.float().numpy()
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=1e-2 * scale, rtol=1e-2)


@pytest.mark.parametrize("act", [None, "gelu_tanh"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("rows", [2, 37, 300])
@pytest.mark.parametrize("impl", ["xla_body", "pallas"])
def test_w8a8_matches_jax(impl, rows, bias, act):
    p, xj, args = _operands(rows, bias)
    if impl == "pallas":   # fused: the activation on the fp32 epilogue
        ref = int8_linear_pallas(p, xj, act=act)
        out = w8a8_linear(*args, act=act)
    else:                  # the XLA body, activation on the stored output
        ref = _int8_linear_body(p, xj)
        out = w8a8_linear(*args)
        if act is not None:
            ref = _EPILOGUE_ACTS[act](ref)
            out = ACT[act](out)
    assert out.dtype == torch.bfloat16
    _close(out, ref)


def test_activation_codes_match_jax():
    """Per-token codes and scales of the activations equal the JAX body's
    formula (amax in bf16, sx = max(amax, 1e-8)/127, round(x / sx))."""
    _, xj, (xt, _, _, _) = _operands(37, False)
    amax = jnp.max(jnp.abs(xj), axis=-1, keepdims=True).astype(jnp.float32)
    sx = jnp.maximum(amax, 1e-8) * (1.0 / 127.0)
    xq = jnp.round(xj.astype(jnp.float32) / sx).astype(jnp.int8)
    got_q, got_s = quantize_rows(xt)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(sx))


def test_epilogue_acts_match_jax_keys():
    assert set(EPILOGUE_ACTS) == set(_EPILOGUE_ACTS)
    y = torch.linspace(-4, 4, 41)
    for name, fn in EPILOGUE_ACTS.items():
        ref = np.asarray(_EPILOGUE_ACTS[name](jnp.asarray(y.numpy())))
        np.testing.assert_allclose(fn(y).numpy(), ref, rtol=1e-5, atol=1e-6)


def test_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors the wrapper returns the plain version's result and
    counts no launch; a [B, L, h] input and an input-axis weight slice
    work."""
    _, _, (xt, wt, so, bt) = _operands(40, True)
    n0 = w8a8_linear.LAUNCHES
    x3 = xt.reshape(2, 20, H)[..., 128:]
    got = w8a8_linear(x3, wt[:, 128:], so, bt, "gelu_tanh")
    want = w8a8_linear_plain(x3, wt[:, 128:], so, bt, "gelu_tanh")
    assert got.shape == (2, 20, N) and torch.equal(got, want)
    assert w8a8_linear.LAUNCHES == n0
    with pytest.raises(ValueError, match="activation"):
        w8a8_linear(xt, wt, so, act="tanh")
    assert jax.default_backend() == "cpu"
