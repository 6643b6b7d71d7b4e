"""The port's int8 Q.K^T flash attention (ops/flash_attention.py:
flash_attention_int8, kernels B8a/B8b) against the JAX package's on the CPU.

The JAX side runs flash_attention_int8 as its own tests do: its Pallas
kernels in interpret mode. The port runs the wrappers' plain version with
the same quantization groups. At S = 1280 the JAX wrapper picks query
blocks of 256 (5 groups) and one key block of 1280 split into 2 key groups
of 640; at S = 200 one group each, padded. Inputs are fp32 from numpy with
masked text padding; the int8 codes agree exactly, so the outputs differ
only by fp32 sums in other orders and the online vs exact softmax:
tolerance 1e-4 relative to the output scale.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.ops.flash_attention import (
    flash_attention_int8 as jax_flash_int8)
from hunyuanvideo_efficiency_tpu_torch.ops import flash_attention as fa
from hunyuanvideo_efficiency_tpu_torch.ops.attention import attention

NEG_INF = -1e30


def _inputs(seed, s, b=2, h=2, d=64, n_pad=20):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    k += 0.7    # a channel-coherent key offset, what smooth_k removes
    kb = np.zeros((b, 1, 1, s), np.float32)
    kb[1, ..., s - n_pad:] = NEG_INF   # padded text keys of one prompt
    return q, k, v, kb


def _close(out, ref):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert out.shape == ref.shape and scale > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4 * scale,
                               rtol=1e-4)


@pytest.mark.parametrize("smooth_k", [True, False])
@pytest.mark.parametrize("bound_mode", ["static", "running"])
@pytest.mark.parametrize("s", [200, 1280])
def test_flash_int8_matches_jax(s, bound_mode, smooth_k):
    q, k, v, kb = _inputs(0, s)
    ref = jax_flash_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         key_bias=jnp.asarray(kb), smooth_k=smooth_k,
                         bound_mode=bound_mode)
    out = fa.flash_attention_int8(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        key_bias=torch.from_numpy(kb), smooth_k=smooth_k,
        bound_mode=bound_mode)
    _close(out, ref)


def test_static_with_score_bound_matches_jax():
    """A weight-derived bound (what the DiT passes), inflated inside."""
    q, k, v, kb = _inputs(1, 1280)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    ref = jax_flash_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         key_bias=jnp.asarray(kb), bound_mode="static",
                         score_bound=jnp.float32(0.25))
    out = fa.flash_attention_int8(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        key_bias=torch.from_numpy(kb), bound_mode="static",
        score_bound=torch.tensor(0.25))
    _close(out, ref)


def test_groups_follow_the_jax_blocks():
    """_pick_block and the key sub-block rule, at the test's lengths and at
    the main path's 4,288 tokens (query groups of 1024; key groups of 512
    static, 1024 running)."""
    from hunyuanvideo_efficiency_tpu.ops.flash_attention import _pick_block

    for s in (200, 1280, 4288, 34936):
        for block in (1024, 2048):
            assert fa.pick_block(block, s) == _pick_block(block, s)
    assert fa.pick_block(1024, 4288) == 1024
    assert fa.int8_key_group(fa.pick_block(2048, 4288), True) == 512
    assert fa.int8_key_group(fa.pick_block(2048, 4288), False) == 1024
    assert fa.int8_key_group(fa.pick_block(2048, 1280), True) == 640


def test_wrappers_on_cpu_and_dispatch():
    """On CPU tensors the kernels' wrappers are the plain version and count
    no launch; attention(mode="flash_int8") maps bound_mode "static" to
    B8a and anything else to B8b, with smoothing on."""
    q, k, v, kb = (torch.from_numpy(a) for a in _inputs(2, 200))
    n0 = (fa.flash_int8_static.LAUNCHES, fa.flash_int8_running.LAUNCHES)
    c = torch.full((2, 2), 9.0)
    kb2 = kb.reshape(2, 200)
    torch.testing.assert_close(
        fa.flash_int8_static(q, k, v, kb2, c, 0.125, 256, 128),
        fa.flash_int8_plain(q, k, v, kb2, c, 0.125, False, 256, 128),
        rtol=0, atol=0)
    for mode, running in (("static", False), ("auto", True)):
        got = attention(q, k, v, mode="flash_int8", key_bias=kb,
                        bound_mode=mode)
        want = fa.flash_attention_int8(
            q, k, v, key_bias=kb,
            bound_mode="running" if running else "static")
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert n0 == (fa.flash_int8_static.LAUNCHES,
                  fa.flash_int8_running.LAUNCHES)


@pytest.mark.parametrize("s,group", [(200, 256), (1280, 256), (1280, 640),
                                     (300, 64)])
def test_quantize_groups_plain_layout_and_codes(s, group):
    """The pre-pass's plain version: int8 codes [B, S, H*D] and fp32 scales
    [B, H, ceil(S/group)], equal to the JAX kernels' own quantization of
    each (batch, head, block) (jnp.round(x * (1/scale)), scale =
    max(max|x|, 1e-6) * (1/127)); a ragged last group sees only its rows."""
    q, _, _, _ = _inputs(3, s, h=3)
    codes, scales = fa.quantize_groups_plain(torch.from_numpy(q), group)
    b, _, h, d = q.shape
    n = -(-s // group)
    assert codes.dtype == torch.int8 and codes.shape == (b, s, h * d)
    assert scales.dtype == torch.float32 and scales.shape == (b, h, n)
    assert codes.is_contiguous() and scales.is_contiguous()
    c4 = codes.reshape(b, s, h, d).numpy()
    for bi in range(b):
        for hi in range(h):
            for gi in range(n):
                blk = jnp.asarray(q[bi, gi * group:(gi + 1) * group, hi])
                sc = jnp.maximum(jnp.max(jnp.abs(blk)), 1e-6) * (1.0 / 127.0)
                q8 = jnp.round(blk * (1.0 / sc)).astype(jnp.int8)
                assert scales[bi, hi, gi].item() == float(sc)
                np.testing.assert_array_equal(
                    c4[bi, gi * group:(gi + 1) * group, hi], np.asarray(q8))
    assert np.abs(c4).max() == 127


def test_quantize_groups_on_cpu_is_the_plain_version():
    """quantize_groups (the pre-pass's entry) on CPU tensors: the plain
    version for q and k with their own groups; the 64-row groups give one
    scale every 64 rows, so a 128-row tile holds two."""
    q, k, _, _ = (torch.from_numpy(a) for a in _inputs(4, 256))
    (q8, sq), (k8, sk) = fa.quantize_groups(q, k, 64, 128)
    for got, want in (((q8, sq), fa.quantize_groups_plain(q, 64)),
                      ((k8, sk), fa.quantize_groups_plain(k, 128))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert sq.shape == (2, 2, 4) and sk.shape == (2, 2, 2)


@pytest.mark.parametrize("running", [False, True])
def test_flash_int8_plain_with_64_row_groups(running):
    """flash_int8_plain with groups of 64 passed directly (two query and
    two key groups in one 128-row tile) against the same attention written
    out from the dequantized codes."""
    q, k, v, kb = (torch.from_numpy(a) for a in _inputs(5, 200))
    kb = kb.reshape(2, 200)
    c = torch.full((2, 2), 9.0)
    scale = 0.125
    out = fa.flash_int8_plain(q, k, v, kb, c, scale, running, 64, 64)
    (q8, sq), (k8, sk) = fa.quantize_groups(q, k, 64, 64)
    qd = (q8.reshape(2, 200, 2, 64).float()
          * sq.repeat_interleave(64, 2)[..., :200].transpose(1, 2)[..., None])
    kd = (k8.reshape(2, 200, 2, 64).float()
          * sk.repeat_interleave(64, 2)[..., :200].transpose(1, 2)[..., None])
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale + kb[:, None, None]
    if running:
        p = torch.softmax(s, dim=-1)
    else:
        p = torch.exp(s - c[:, :, None, None])
        p = p / p.sum(-1, keepdim=True)
    want = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(2, 200, 128)
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bound_mode", ["static", "running"])
def test_states_over_key_halves_merge_to_one_call(bound_mode):
    """return_state with one key_mean for all calls (what the ring's hops
    do): the states of two calls over the key halves, each half whole key
    groups of 128, merge to the one call over every key; the static offsets
    differ between the halves (each its own Cauchy-Schwarz bound)."""
    q, k, v, kb = (torch.from_numpy(a) for a in _inputs(6, 512))
    mean = k.float().mean(dim=1, keepdim=True)
    kw = dict(block_k=256, bound_mode=bound_mode, key_mean=mean,
              return_state=True)
    full = fa.flash_attention_int8(q, k, v, key_bias=kb, **kw)
    halves = [fa.flash_attention_int8(q, k[:, i:i + 256], v[:, i:i + 256],
                                      key_bias=kb[..., i:i + 256], **kw)
              for i in (0, 256)]
    o, m, l = fa.merge_flash_states(*halves)
    torch.testing.assert_close(o, full[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l * torch.exp(m - full[1]), full[2],
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(full[0], fa.flash_attention_int8(
        q, k, v, key_bias=kb, block_k=256, bound_mode=bound_mode), rtol=0,
        atol=0)


@pytest.mark.parametrize("d,q_group,k_group,what", [
    (64, 96, 128, "groups 96/128 are not multiples of 64"),
    (64, 128, 32, "groups 128/32 are not multiples of 64"),
    (64, 0, 64, "groups 0/64 are not multiples of 64"),
    (32, 128, 128, "head_dim 64 or 128, got 32"),
    (96, 128, 128, "head_dim 64 or 128, got 96"),
])
def test_int8_kernel_launch_rejects(d, q_group, k_group, what):
    """The kernels' launch path checks groups and head dims before it
    looks at the device: what the card would refuse fails here too."""
    x = torch.zeros(1, 128, 2, d, dtype=torch.bfloat16)
    c = torch.zeros(1, 2)
    with pytest.raises(ValueError, match=what):
        fa._launch_int8(x, x, x, None, c, 0.1, False, q_group, k_group)
    with pytest.raises(ValueError, match=what):
        fa._launch_int8(x, x, x, None, None, 0.1, True, q_group, k_group)
