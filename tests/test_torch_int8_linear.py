"""The port's W8A8 linear (ops/int8_matmul.py, kernel B9) against the JAX
package's on the CPU: the XLA body `models/dit._int8_linear_body` and the
Pallas kernel `ops/int8_matmul.int8_linear_pallas` in interpret mode, on
the same bf16 activations and int8 weights (h = n = 256), ragged rows, with
and without bias, gelu_tanh fused into the epilogue (Pallas) and applied to
the stored output (XLA body). Then the CUDA kernel's host side, which runs
here: the schedule planner at the full widths of every call the DiT and
the Llama tower make, and the wrapper's rejections.

Tolerance: one bf16 rounding of the output, 1e-2 relative to its scale
(the int8 codes and the exact s32 sums agree; the fp32 epilogue may round
once more or less in XLA's fused order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.models.dit import _int8_linear_body
from hunyuanvideo_efficiency_tpu.ops.int8_matmul import (_EPILOGUE_ACTS,
                                                         int8_linear_pallas)
from hunyuanvideo_efficiency_tpu.ops.quantization import quantize_tensor_int8
from hunyuanvideo_efficiency_tpu_torch.models.dit import ACT
from hunyuanvideo_efficiency_tpu_torch.ops.int8_matmul import (
    BK, EPILOGUE_ACTS, SHORT_M, plan_segments, plan_w8a8, quantize_rows,
    w8a8_linear, w8a8_linear_plain, w8a8_prepass)

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


# (M, N, K) of every W8A8 call class of the int8 path at 256x448x33f under
# CFG: the double block's image (8,064 rows) and text (512) linears, its
# modulation (2 rows), the single block's linear1 column slices, linear2 K
# slices (8,576 rows) and modulation; the Llama-3-8B tower (hidden 4096,
# MLP 14336, 8 KV heads) at the text encoder's 351 rows (256 + the
# template's crop) and at 1 and 77 rows.
DIT_CALLS = [(m, n, k) for m in (8064, 512) for n, k in (
    (9216, 3072), (3072, 3072), (12288, 3072), (3072, 12288))] + [
    (2, 18432, 3072), (8576, 9216, 3072), (8576, 12288, 3072),
    (8576, 3072, 3072), (8576, 3072, 12288), (2, 9216, 3072),
    (2, 6144, 3072)]
LLAMA_CALLS = [(m, n, k) for m in (1, 77, 351) for n, k in (
    (4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336))]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("m,n,k", DIT_CALLS + LLAMA_CALLS)
def test_w8a8_plan_covers_the_output_once(m, n, k, sms):
    """Every segment's tile starts inside the [M, N] output, the segments
    cover each (tile, 128-byte K step) exactly once, K is split in whole
    128-byte steps, the short schedule is taken exactly for M <= 64 (each
    CTA then flushes partial sums at most twice beyond its whole tiles),
    and the grid never exceeds the SM count or the units."""
    plan = plan_w8a8(m, n, k, sms)
    assert (plan.bm, plan.bn) in ((128, 256), (128, 128), (64, 128))
    assert (plan.m_tiles, plan.n_tiles) == (-(-m // plan.bm),
                                            -(-n // plan.bn))
    assert plan.k_steps * BK == k and 1 <= plan.split <= plan.k_steps
    assert 1 <= plan.grid <= min(sms, plan.units)
    if m <= SHORT_M:
        assert (plan.bm, plan.bn, plan.m_tiles) == (64, 128, 1)
    else:
        assert plan.split == 1
    seen = np.zeros((plan.m_tiles, plan.n_tiles, plan.k_steps), np.int32)
    partial = np.zeros(plan.grid, np.int32)
    for c, r0, c0, k0, k1 in plan_segments(plan):
        assert 0 <= c < plan.grid
        assert 0 <= r0 < m and 0 <= c0 < n
        assert r0 % plan.bm == 0 and c0 % plan.bn == 0
        assert k0 % BK == 0 and k1 % BK == 0 and 0 <= k0 < k1 <= k
        seen[r0 // plan.bm, c0 // plan.bn, k0 // BK:k1 // BK] += 1
        partial[c] += k1 - k0 < k
    assert (seen == 1).all()
    assert partial.max() <= 2


def test_w8a8_plan_choices():
    """What the planner picks at the main path's shapes on 132 SMs: the
    matvecs split K in single steps over every SM (26 or 27 of the 3,456
    (tile, step) units each); the image rows take 128 x 256 tiles, the 512
    text rows 128 x 128 (288 tiles, not 144 wide ones on 132 SMs); tiles
    are walked in groups of 8 row tiles, the first 132 in flight sharing
    17 weight column tiles."""
    mv = plan_w8a8(2, 18432, 3072, 132)
    assert (mv.bm, mv.bn, mv.split, mv.grid) == (64, 128, 24, 132)
    steps = np.zeros(132, np.int32)
    for c, _, _, k0, k1 in plan_segments(mv):
        steps[c] += (k1 - k0) // BK
    assert steps.min() == 26 and steps.max() == 27
    qkv = plan_w8a8(8064, 9216, 3072, 132)
    assert (qkv.bm, qkv.bn, qkv.split, qkv.grid) == (128, 256, 1, 132)
    txt = plan_w8a8(512, 9216, 3072, 132)
    assert (txt.bm, txt.bn, txt.units) == (128, 128, 288)
    first_wave = {}
    for c, r0, c0, _, _ in plan_segments(qkv):
        first_wave.setdefault(c, (r0, c0))
    assert {r for r, _ in first_wave.values()} == {128 * i for i in range(8)}
    assert len({col for _, col in first_wave.values()}) == 17


# the CUDA tests' cases (tests/test_torch_cuda_kernels.py: W8A8_CASES) as
# (M, K, N): which schedule each reaches on a 132-SM card
CUDA_CASES = [(1, 384, 256), (2, 512, 384), (63, 256, 256), (64, 256, 256),
              (65, 256, 256), (77, 256, 256), (129, 256, 128),
              (300, 512, 640), (512, 256, 9216), (6000, 256, 384),
              (8064, 256, 2304)]


def test_w8a8_cuda_cases_reach_every_schedule():
    plans = {(m, k, n): plan_w8a8(m, n, k, 132) for m, k, n in CUDA_CASES}
    tiles = {(p.bm, p.bn) for p in plans.values()}
    assert tiles == {(128, 256), (128, 128), (64, 128)}
    assert any(p.split > 1 for p in plans.values())
    assert plans[(65, 256, 256)].bm == 64 and plans[(65, 256, 256)].split == 1
    ragged = plans[(6000, 256, 384)]
    assert (ragged.bn, ragged.n_tiles) == (256, 2)       # 384 = 256 + 128


def test_w8a8_wrapper_rejects():
    """What the kernel does not take is refused before any launch (meta
    tensors stand for a device that is not the CPU); CPU tensors take the
    plain version; the pre-pass on the CPU is quantize_rows."""
    w = torch.zeros(256, 256, dtype=torch.int8, device="meta")
    so = torch.ones(256, device="meta")
    x = torch.zeros(4, 256, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="activation"):
        w8a8_linear(x, w, so, act="tanh")
    with pytest.raises(TypeError, match="bf16 or fp16"):
        w8a8_linear(x.float(), w, so)
    with pytest.raises(TypeError, match="int8 weight"):
        w8a8_linear(x, w.float(), so)
    with pytest.raises(ValueError, match="multiples of 128"):
        w8a8_linear(x[:, :192], w[:, :192], so)
    with pytest.raises(ValueError, match="multiples of 128"):
        w8a8_linear(x, w[:192], so[:192])
    with pytest.raises(ValueError, match="not a CUDA device"):
        w8a8_linear(x, w, so)
    with pytest.raises(ValueError, match="pre-pass"):
        w8a8_prepass(x)
    _, _, (xt, _, _, _) = _operands(37, False)
    xq, sx = w8a8_prepass(xt)
    rq, rs = quantize_rows(xt)
    assert torch.equal(xq, rq) and torch.equal(sx, rs[:, 0])
