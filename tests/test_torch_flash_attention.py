"""The port's flash attention (K1 static offset, K2 running max) against the
JAX package's Pallas kernels, on the CPU.

On the CPU the port's wrappers run their plain versions and the JAX
flash_attention runs its Pallas kernels in interpret mode, so this pins the
kernels' shared math: offsets, key bias, ragged lengths and the
partial-softmax state. Inputs are fp32 from numpy; tolerance 2e-5 absolute
(fp32 sums in different orders, values O(1)).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.ops.flash_attention import (
    flash_attention as jax_flash, merge_flash_states as jax_merge)
from hunyuanvideo_efficiency_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_plain, flash_running, flash_static,
    merge_flash_states)

ATOL = 2e-5


def _inputs(seed, b=2, s=72, h=4, d=32, n_pad=9):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    kb = np.zeros((b, s), np.float32)
    kb[1, s - n_pad:] = -1e30      # padded text keys of the second prompt
    return q, k, v, kb


@pytest.mark.parametrize("bound_mode", ["static", "running"])
@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("s", [72, 200])   # 200: ragged against 128 blocks
def test_flash_matches_jax(bound_mode, return_state, s):
    q, k, v, kb = _inputs(0, s=s)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    key_bias=jnp.asarray(kb)[:, None, None, :],
                    bound_mode=bound_mode, return_state=return_state)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v),
                          key_bias=torch.from_numpy(kb)[:, None, None, :],
                          bound_mode=bound_mode, return_state=return_state)
    if not return_state:
        ref, out = (ref,), (out,)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=1e-5)


def test_static_with_analytic_bound_matches_jax():
    """A weight-derived score bound C (what the DiT passes) instead of the
    Cauchy-Schwarz bound: same output, state m = C."""
    q, k, v, kb = _inputs(1)
    c = np.float32(7.5)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    key_bias=jnp.asarray(kb)[:, None, None, :],
                    bound_mode="static", score_bound=jnp.asarray(c),
                    return_state=True)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v),
                          key_bias=torch.from_numpy(kb)[:, None, None, :],
                          bound_mode="static",
                          score_bound=torch.tensor(c), return_state=True)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=1e-5)
    assert torch.all(out[1] == 7.5)


def test_merge_flash_states_matches_jax_and_full():
    """Two key halves with state, merged, equal attention over all keys."""
    q, k, v, _ = _inputs(2)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    halves = [flash_attention(tq, tk[:, sl], tv[:, sl], bound_mode="running",
                              return_state=True)
              for sl in (slice(0, 40), slice(40, None))]
    merged = merge_flash_states(*halves)
    full = flash_attention(tq, tk, tv, bound_mode="running")
    np.testing.assert_allclose(merged[0].numpy(), full.numpy(), atol=ATOL)
    jax_halves = [tuple(jnp.asarray(x.numpy()) for x in hv) for hv in halves]
    ref = jax_merge(*jax_halves)
    for r, o in zip(ref, merged):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)


def test_wrappers_use_plain_version_on_cpu():
    """On CPU tensors the wrappers compute the plain version and launch no
    kernel; the plain static and running forms agree."""
    q, k, v, kb = (torch.from_numpy(a) for a in _inputs(3))
    before = (flash_static.LAUNCHES, flash_running.LAUNCHES)
    c = torch.full((2, 4), 9.0)
    out_s = flash_static(q, k, v, kb, c, 32 ** -0.5)
    out_r = flash_running(q, k, v, kb, 32 ** -0.5)
    assert (flash_static.LAUNCHES, flash_running.LAUNCHES) == before
    np.testing.assert_allclose(out_s.numpy(), out_r.numpy(), atol=ATOL)
    np.testing.assert_array_equal(
        out_s.numpy(),
        flash_attention_plain(q, k, v, kb, c, 32 ** -0.5, False).numpy())


@pytest.mark.parametrize("shape,sms,want", [
    ((2, 24, 4288, 4288), 132, 1),    # the main path: 1632 blocks
    ((2, 24, 256, 34680), 132, 4),    # the 540p STA text merge: 96 blocks
    ((2, 24, 256, 256), 132, 1),      # its text keys alone: 2 key tiles
    ((1, 2, 256, 34680), 132, 33),    # 4 blocks: 271 key tiles / 8 a split
    ((2, 3, 200, 1000), 132, 1),      # 8 key tiles: too few to split
])
def test_flash_splits_from_shapes(shape, sms, want):
    """The key-range split of the CUDA wrappers: none once the query tiles
    give two blocks an SM, else two blocks an SM with a full last wave
    where the keys allow, each split at least MIN_SPLIT_TILES key tiles
    long."""
    from hunyuanvideo_efficiency_tpu_torch.ops.flash_attention import (
        BLOCK_K, BLOCK_Q, MIN_SPLIT_TILES, flash_splits)

    b, h, sq, sk = shape
    n = flash_splits(b, h, sq, sk, sms)
    assert n == want
    blocks = -(-sq // BLOCK_Q) * h * b
    most = -(-sk // BLOCK_K) // MIN_SPLIT_TILES
    if n > 1:
        assert blocks * n >= 2 * sms or n == most
        assert n <= most
