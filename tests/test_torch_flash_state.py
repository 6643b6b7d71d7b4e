"""The port's `flash_attention_state` (ops/flash_attention.py: K1 with
state forward, the plain chunked transpose backward) against the JAX
package's on the CPU.

The JAX side runs its Pallas kernel in interpret mode (forward) and
`jax.vjp` of `_state_reference` (backward), as
tests/test_flash_backward.py:113-180 runs it; the port runs K1's plain
version and the autograd of `state_reference`. Inputs are numpy draws from
a seed, fp32. Tolerance 1e-4 (rtol and atol): both sides compute the same
fp32 sums, in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.ops.flash_attention import (
    flash_attention_state as jax_state, merge_flash_states as jax_merge)
from hunyuanvideo_efficiency_tpu_torch.ops.attention import sdpa_attention
from hunyuanvideo_efficiency_tpu_torch.ops.flash_attention import (
    flash_attention_state, merge_flash_states, state_reference)

TOL = dict(rtol=1e-4, atol=1e-4)
NEG_INF = -1e30


def _data(s=200, h=2, d=64, txt=24, seed=0, b=2):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) * 0.5
               for _ in range(3))
    mask = rng.random((b, txt)) > 0.3
    mask[:, 0] = True
    bias = np.zeros((b, 1, 1, s), np.float32)
    bias[:, 0, 0, s - txt:] = np.where(mask, 0.0, NEG_INF)
    return q, k, v, bias


def _leaves(*xs):
    return [torch.from_numpy(x).requires_grad_(True) for x in xs]


@pytest.mark.parametrize("bound,k_chunk", [(6.0, 2048), (None, 64)])
def test_state_and_vjp_match_jax(bound, k_chunk):
    """(out, m, l) and the VJP with respect to q, k, v and key_bias, for
    cotangents on out and l; a static bound, or the norms' bound."""
    q, k, v, bias = _data(seed=3)
    rng = np.random.default_rng(4)
    g_out = rng.standard_normal((2, 200, 128)).astype(np.float32)
    g_l = rng.standard_normal((2, 200, 2)).astype(np.float32) * 0.1

    def jfn(q, k, v, bias):
        out, m, l = jax_state(q, k, v, bias, score_bound=bound,
                              k_chunk=k_chunk)
        return out, m, l

    want, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v, bias)))
    want_g = vjp((jnp.asarray(g_out), jnp.zeros_like(want[1]),
                  jnp.asarray(g_l)))

    ins = _leaves(q, k, v, bias)
    got = flash_attention_state(*ins, score_bound=bound, k_chunk=k_chunk)
    for a, b_, name in zip(got, want, ("out", "m", "l")):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b_),
                                   err_msg=name, **TOL)
    got_g = torch.autograd.grad((got[0], got[2]), ins,
                                (torch.from_numpy(g_out),
                                 torch.from_numpy(g_l)))
    for a, b_, name in zip(got_g, want_g, ("dq", "dk", "dv", "dbias")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), err_msg=name,
                                   **TOL)


def test_two_shards_merged_match_jax():
    """Two key shards, each a state, merged (a 2-hop ring): the merged
    output and its gradients against JAX's, and against dense attention
    over the whole key set."""
    q, k, v, bias = _data(s=256, seed=5)
    halves = (slice(0, 128), slice(128, 256))

    def jloss(q, k, v):
        st = [jax_state(q, k[:, hs], v[:, hs], jnp.asarray(bias)[..., hs],
                        score_bound=8.0) for hs in halves]
        out, _, _ = jax_merge(*st)
        return jnp.sum(jnp.sin(out) * 0.1)

    want_val, want_g = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))

    def loss(q, k, v, merged=True):
        if not merged:
            out = sdpa_attention(q, k, v, bias=torch.from_numpy(bias))
            return torch.sum(torch.sin(out) * 0.1)
        st = [flash_attention_state(q, k[:, hs], v[:, hs],
                                    torch.from_numpy(bias)[..., hs],
                                    score_bound=8.0) for hs in halves]
        return torch.sum(torch.sin(merge_flash_states(*st)[0]) * 0.1)

    for merged in (True, False):
        ins = _leaves(q, k, v)
        val = loss(*ins, merged=merged)
        got_g = torch.autograd.grad(val, ins)
        np.testing.assert_allclose(float(val.detach()), float(want_val), **TOL)
        for a, b_, name in zip(got_g, want_g, "qkv"):
            np.testing.assert_allclose(a.numpy(), np.asarray(b_),
                                       err_msg=f"d{name} merged={merged}",
                                       **TOL)


def test_offset_takes_no_gradient():
    """C is detached: a score_bound that asks for a gradient gets none, and
    the norms' bound passes no gradient into q and k beyond attention's."""
    q, k, v, bias = _data(s=128, seed=7)
    c = torch.tensor(7.0, requires_grad=True)
    ins = _leaves(q, k, v)
    out, m, l = flash_attention_state(*ins, torch.from_numpy(bias),
                                      score_bound=c)
    assert not m.requires_grad
    (out.sum() + l.sum()).backward()
    assert c.grad is None
    # the same gradients whatever the offset: the state is C-invariant up
    # to l's scale, so hold out's gradients alone
    grads = []
    for bound in (7.0, None):
        ins = _leaves(q, k, v)
        o, _, _ = flash_attention_state(*ins, torch.from_numpy(bias),
                                        score_bound=bound)
        grads.append(torch.autograd.grad(torch.sin(o).sum(), ins))
    for a, b_ in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), **TOL)


def test_state_reference_chunks_agree():
    """The chunked replica gives the same state for any chunk size, and
    equals the forward the kernel wrapper returns."""
    q, k, v, bias = (torch.from_numpy(x) for x in _data(s=200, seed=9))
    c = torch.full((2, 2), 6.0)
    whole = state_reference(q, k, v, bias, c, 0.125, k_chunk=4096)
    for chunk in (64, 77):
        part = state_reference(q, k, v, bias, c, 0.125, k_chunk=chunk)
        for a, b_ in zip(part, whole):
            np.testing.assert_allclose(a.numpy(), b_.numpy(), **TOL)
    fwd = flash_attention_state(q, k, v, bias, 0.125, c)
    for a, b_ in zip(fwd, whole):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), **TOL)
