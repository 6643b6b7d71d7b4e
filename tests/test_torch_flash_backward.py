"""The port's differentiable attention (ops/flash_backward.py, the trainable
STA wrapper) against the JAX package's on the CPU.

The JAX side runs `flash_attention_vjp` under `jax.grad`, i.e. its three
Pallas kernels in interpret mode; the port runs `FlashAttentionVJP` on the
kernel wrappers' plain versions. Inputs are numpy draws from a seed, fp32.
Tolerance: 5e-3 (rtol and atol), what tests/test_flash_backward.py grants the
JAX kernels against autodiff of plain attention: the JAX kernels pad S to
their blocks and sum in another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.models.dit import init_dit_params
from hunyuanvideo_efficiency_tpu.models.dit_config import DiTConfig as JCfg
from hunyuanvideo_efficiency_tpu.ops import flash_backward as jfb
from hunyuanvideo_efficiency_tpu.ops import sta as jsta
from hunyuanvideo_efficiency_tpu.ops.rope import (
    get_nd_rotary_pos_embed as jax_rope)
from hunyuanvideo_efficiency_tpu.training import (
    flow_match_loss as jax_flow_match_loss)
from hunyuanvideo_efficiency_tpu_torch.models.dit import (HYVideoDiT,
                                                          patchify_raw)
from hunyuanvideo_efficiency_tpu_torch.models.dit_config import DiTConfig
from hunyuanvideo_efficiency_tpu_torch.ops import flash_backward as fb
from hunyuanvideo_efficiency_tpu_torch.ops import sta
from hunyuanvideo_efficiency_tpu_torch.ops.attention import (attention,
                                                             joint_attention,
                                                             sdpa_attention)
from hunyuanvideo_efficiency_tpu_torch.ops.rope import get_nd_rotary_pos_embed
from hunyuanvideo_efficiency_tpu_torch.training import flow_match_loss
from hunyuanvideo_efficiency_tpu_torch.utils.weights import (
    dit_state_dict_from_jax)

NEG_INF = -1e30
TOL = dict(rtol=5e-3, atol=5e-3)


def _data(s, h=2, d=128, txt=24, seed=0, b=2):
    """q, k, v [B, S, H, D] (0.5 * N(0, 1)) and a key bias [B, 1, 1, S]
    masking some of the last `txt` keys (None when txt == 0)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) * 0.5
               for _ in range(3))
    if txt == 0:
        return q, k, v, None
    mask = rng.random((b, txt)) > 0.3
    mask[:, 0] = True
    bias = np.zeros((b, 1, 1, s), np.float32)
    bias[:, 0, 0, s - txt:] = np.where(mask, 0.0, NEG_INF)
    return q, k, v, bias


def _leaf(x):
    return torch.from_numpy(x).requires_grad_(True)


# s, JAX block_q, block_k, text keys: the shapes of
# tests/test_flash_backward.py (one and two key sub-tiles, ragged padding)
VJP_CASES = [(128, 128, 128, 24), (160, 128, 128, 24), (200, 128, 128, 24),
             (330, 128, 256, 24), (128, 128, 128, 0)]


@pytest.mark.parametrize("s,bq,bk,txt", VJP_CASES)
def test_flash_vjp_matches_jax(s, bq, bk, txt):
    """Forward and dQ/dK/dV of flash_attention_vjp under the loss
    sum(sin(out) * 0.1)."""
    q, k, v, bias = _data(s, txt=txt)
    jb = None if bias is None else jnp.asarray(bias)

    def jloss(q_, k_, v_):
        o = jfb.flash_attention_vjp(q_, k_, v_, jb, None, None, bq, bk)
        return jnp.sum(jnp.sin(o) * 0.1), o

    (_, want_out), want = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (q, k, v)))

    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    tb = None if bias is None else torch.from_numpy(bias)
    counts = (fb.flash_fwd_lse.LAUNCHES, fb.flash_bwd_dq.LAUNCHES,
              fb.flash_bwd_dkv.LAUNCHES)
    out = fb.flash_attention_vjp(tq, tk, tv, tb, None, None, bq, bk)
    assert isinstance(out.grad_fn, fb.FlashAttentionVJP._backward_cls)
    (torch.sin(out) * 0.1).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               **TOL)
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        assert got.shape == ref.shape and got.dtype == torch.float32
        assert float(np.abs(np.asarray(ref)).max()) > 1e-3
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL,
                                   err_msg=f"d{name}")
    # CPU tensors take the plain versions: no launch is counted
    assert counts == (fb.flash_fwd_lse.LAUNCHES, fb.flash_bwd_dq.LAUNCHES,
                      fb.flash_bwd_dkv.LAUNCHES)


@pytest.mark.parametrize("s,bq,bk", [(160, 128, 128), (330, 128, 256)])
def test_lse_matches_jax_forward_kernel(s, bq, bk):
    """out and lse of flash_fwd_lse against JAX's `_fwd_with_lse` (its
    padded [B, H*8, Sq] layout read back as [B, H, Sq])."""
    q, k, v, bias = _data(s, seed=1)
    b, _, h, d = q.shape
    qp, kp, vp, kb, bq_, bk_, _, _ = jfb._prep(
        *map(jnp.asarray, (q, k, v, bias)), bq, bk)
    want_out, want_lse = jfb._fwd_with_lse(qp, kp, vp, kb, h, d ** -0.5, bq_,
                                           bk_, True)
    out, lse = fb.flash_fwd_lse(*map(torch.from_numpy, (q, k, v)),
                                torch.from_numpy(bias).reshape(b, s),
                                d ** -0.5)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out)[:, :s],
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want_lse)[:, ::8, :s], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("sq,sk,d,txt", [(70, 70, 64, 9), (64, 200, 128, 0),
                                         (130, 77, 64, 20)])
def test_plain_backward_matches_autograd_of_sdpa(sq, sk, d, txt):
    """flash_fwd_lse_plain + flash_bwd_plain (what the kernels compute)
    against torch autograd through plain attention, with other query and key
    lengths; masked keys get exactly zero dK and dV."""
    rng = np.random.default_rng(2)
    q = _leaf(rng.standard_normal((2, sq, 3, d)).astype(np.float32) * 0.5)
    k, v = (_leaf(rng.standard_normal((2, sk, 3, d)).astype(np.float32) * 0.5)
            for _ in range(2))
    kb = torch.zeros(2, sk)
    if txt:
        kb[1, sk - txt:] = NEG_INF
    g = torch.from_numpy(rng.standard_normal((2, sq, 3 * d)).astype(
        np.float32))
    ref = sdpa_attention(q, k, v, bias=kb[:, None, None, :])
    want = torch.autograd.grad(ref, (q, k, v), g)
    with torch.no_grad():
        out, lse = fb.flash_fwd_lse_plain(q, k, v, kb, d ** -0.5)
        delta = fb.row_delta(g, out, 3)
        got = fb.flash_bwd_plain(q, k, v, kb, g, lse, delta, d ** -0.5)
    torch.testing.assert_close(out, ref.detach(), rtol=1e-5, atol=1e-5)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-5)
    if txt:
        assert torch.count_nonzero(got[1][1, sk - txt:]) == 0
        assert torch.count_nonzero(got[2][1, sk - txt:]) == 0


# (kernel, b, h, sq, sk, d): the train step's shape, ragged edges on both
# sides, keys under one tile, D = 64
PLAN_CASES = [("dq", 1, 24, 4288, 4288, 128), ("dkv", 1, 24, 4288, 4288, 128),
              ("dq", 2, 3, 129, 129, 64), ("dkv", 2, 3, 63, 191, 128),
              ("dkv", 2, 3, 200, 50, 64)]


@pytest.mark.parametrize("kernel,b,h,sq,sk,d", PLAN_CASES)
def test_flash_bwd_plan(kernel, b, h, sq, sk, d):
    """plan_flash_bwd: a block per 128 rows of its own side and (b, h), one
    ring turn per 64 rows of the other, shared memory within the H100's
    227 KB a block; the tile sizes are the CUDA source's."""
    plan = fb.plan_flash_bwd(kernel, b, h, sq, sk, d)
    own, other = (sq, sk) if kernel == "dq" else (sk, sq)
    assert plan.grid == (-(-own // 128), h, b)
    assert plan.turns == -(-other // 64)
    assert plan.grid[0] * plan.rows >= own > (plan.grid[0] - 1) * plan.rows
    assert plan.smem <= 232448
    src = (fb.cuda_lib.CSRC / "flash_backward.cu").read_text()
    for name, value in (("ROWS", plan.rows), ("TILE", plan.tile),
                        ("RING", plan.ring)):
        assert f"constexpr int {name} = {value};" in src, name
    if (kernel, sq) == ("dq", 4288):  # 34 x 24 blocks: 6.2 waves on 132 SMs
        assert plan.grid == (34, 24, 1) and plan.turns == 67
    with pytest.raises(ValueError):
        fb.plan_flash_bwd("dv", b, h, sq, sk, d)


def _view(kind):
    """(shape, strides, data_ptr) of a [2, 100, 3, 64] bf16 view."""
    b, s, h, d = 2, 100, 3, 64
    if kind == "contiguous":
        return (b, s, h, d), (s * h * d, h * d, d, 1), 1024
    if kind == "fused column":      # v of a [B, S, 3, H, D] projection
        return ((b, s, h, d), (3 * s * h * d, 3 * h * d, d, 1),
                1024 + 2 * h * d * 2)
    if kind == "heads apart":       # [B, H, S, D] transposed to [B, S, H, D]
        return (b, s, h, d), (s * h * d, d, s * d, 1), 1024
    if kind == "odd row stride":
        return (b, s, h, d), (s * (h * d + 4), h * d + 4, d, 1), 1024
    return (b, s, h, d), (s * h * d, h * d, d, 1), 1026  # misaligned base


@pytest.mark.parametrize("kind,ok", [
    ("contiguous", True), ("fused column", True), ("heads apart", False),
    ("odd row stride", False), ("misaligned base", False)])
def test_tma_view_error(kind, ok):
    """The views the backward wrappers hand to TMA: contiguous and column
    views of a fused projection pass; heads not packed in a row, a row
    stride or a base off 16 bytes are refused with a reason."""
    shape, strides, ptr = _view(kind)
    err = fb.tma_view_error("v", shape, strides, ptr, 2)
    assert (err is None) == ok, err
    if not ok:
        assert err.startswith("v: ")


def _kernel_arithmetic(q, k, v, kb, do, lse, delta, scale):
    """dQ, dK, dV as csrc/flash_backward.cu computes them, in fp32: every
    operand padded with zero rows to whole tiles (TMA's zero fill), padded
    keys given the bias -1e30 and padded query rows the lse +1e30 (dK/dV)
    or 0 (dQ) and delta 0, exponentials in log2 units."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    pq, pk = -(-sq // 128) * 128, -(-sk // 128) * 128

    def rows(x, n):
        return torch.nn.functional.pad(x.float(),
                                       (0, 0, 0, 0, 0, n - x.shape[1]))

    qf, dof = rows(q, pq), rows(do.reshape(b, sq, h, d), pq)
    kf, vf = rows(k, pk), rows(v, pk)
    bias = torch.full((b, pk), NEG_INF)
    bias[:, :sk] = kb
    log2e = 1.4426950408889634
    s2 = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * (scale * log2e) \
        + bias[:, None, None, :] * log2e
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)

    def pad_rows(x, fill):          # [B, H, Sq] -> [B, H, pq]
        return torch.nn.functional.pad(x, (0, pq - sq), value=fill)

    out = []
    for lse_fill in (0.0, 1e30):    # dQ's padded rows, then dK/dV's
        p = torch.exp2(s2 - pad_rows(lse * log2e, lse_fill)[..., None])
        ds = p * (dp - pad_rows(delta, 0.0)[..., None])
        out.append((p, ds))
    (_, ds_q), (p_kv, ds_kv) = out
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_q.to(q.dtype).float(), kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_kv.to(q.dtype).float(), qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p_kv.to(q.dtype).float(), dof)
    return dq[:, :sq], dk[:, :sk], dv[:, :sk]


@pytest.mark.parametrize("sq,sk,masked", [(129, 129, 7), (63, 191, 0),
                                          (200, 50, 10)])
def test_zero_filled_tiles_add_nothing(sq, sk, masked):
    """The kernels' handling of ragged edges (zero rows past Sq and Sk, no
    masks) gives the plain version's dQ, dK and dV, and exactly zero dK and
    dV on masked keys: the padded rows' terms are exactly zero."""
    rng = np.random.default_rng(5)
    d, h = 64, 2
    q, k, v = (torch.from_numpy(rng.standard_normal((2, n, h, d)).astype(
        np.float32) * 0.5) for n in (sq, sk, sk))
    do = torch.from_numpy(rng.standard_normal((2, sq, h * d)).astype(
        np.float32))
    kb = torch.zeros(2, sk)
    if masked:
        kb[1, sk - masked:] = NEG_INF
    scale = d ** -0.5
    out, lse = fb.flash_fwd_lse_plain(q, k, v, kb, scale)
    delta = fb.row_delta(do, out, h)
    args = (q, k, v, kb, do, lse, delta, scale)
    got = _kernel_arithmetic(*args)
    want = fb.flash_bwd_plain(*args)
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-5, msg=name)
    if masked:
        assert torch.count_nonzero(got[1][1, sk - masked:]) == 0
        assert torch.count_nonzero(got[2][1, sk - masked:]) == 0


def test_no_grad_call_takes_the_lse_free_kernel(monkeypatch):
    """Without a gradient to compute, attention(mode="flash") is the
    LSE-free dispatch (K1 under a static bound); with one, the VJP."""
    q, k, v, bias = _data(128, seed=3)
    tq, tk, tv, tb = map(torch.from_numpy, (q, k, v, bias))
    calls = []
    import hunyuanvideo_efficiency_tpu_torch.ops.flash_attention as fa

    real = fa.flash_static
    monkeypatch.setattr(fa, "flash_static",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    kw = dict(mode="flash", key_bias=tb, bound_mode="static",
              score_bound=torch.tensor(8.0))
    plain = attention(tq, tk, tv, **kw)
    assert len(calls) == 1 and not plain.requires_grad
    with torch.no_grad():
        attention(tq.clone().requires_grad_(True), tk, tv, **kw)
    assert len(calls) == 2
    diff = attention(tq.clone().requires_grad_(True), tk, tv, **kw)
    assert len(calls) == 2 and diff.requires_grad
    torch.testing.assert_close(diff.detach(), plain, rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="inference only"):
        attention(tq.clone().requires_grad_(True), tk, tv, mode="flash_int8")


# --------------------------------------------------------------------------
# trainable STA
# --------------------------------------------------------------------------

def _sta_inputs(grid, seed, b=1, h=2, d=32, lt=12):
    rng = np.random.default_rng(seed)
    s = grid[0] * grid[1] * grid[2]
    xs = [rng.standard_normal((b, n, h, d)).astype(np.float32) * 0.5
          for n in (s, s, s, lt, lt, lt)]
    mask = rng.random((b, lt)) > 0.3
    mask[:, 0] = True
    tb = np.where(mask, 0.0, NEG_INF).astype(np.float32)[:, None, None, :]
    return xs, tb


@pytest.mark.parametrize("geom", [((3, 5, 6), (1, 2, 4), (3, 3, 3)),
                                  ((2, 4, 8), (1, 2, 4), (1, 3, 3))],
                         ids=["ragged", "window133"])
def test_sta_trainable_grads_match_jax(geom):
    """Forward (kernel dispatch; plain versions here) and the six input
    gradients of sta_joint_attention_trainable under QK-norm-like static
    bounds, against JAX's wrapper (Pallas forward in interpret mode,
    gathered-form backward)."""
    grid, tile, window = geom
    xs, tb = _sta_inputs(grid, seed=4)
    kw = dict(grid=grid, tile=tile, window=window, bound_mode="static")

    def jloss(*ins):
        io, to = jsta.sta_joint_attention_trainable(
            *ins, jnp.asarray(tb), score_bound=jnp.float32(4.0), **kw)
        return jnp.sum(jnp.sin(io)) + jnp.sum(jnp.cos(to)), (io, to)

    (_, want_out), want = jax.value_and_grad(
        jloss, argnums=tuple(range(6)), has_aux=True)(*map(jnp.asarray, xs))

    ins = [_leaf(x) for x in xs]
    io, to = sta.sta_joint_attention_trainable(
        *ins, torch.from_numpy(tb), score_bound=torch.tensor(4.0), **kw)
    (torch.sin(io).sum() + torch.cos(to).sum()).backward()
    for got, ref in zip((io, to), want_out):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)
    for got, ref, name in zip(ins, want, ("iq", "ik", "iv", "tq", "tk",
                                          "tv")):
        assert float(np.abs(np.asarray(ref)).max()) > 1e-3
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_sta_gathered_forward_is_the_kernels_function():
    """The gathered form computes what the STA dispatch computes, and
    joint_attention(mode="sta") is differentiable through it."""
    grid, tile, window = (3, 5, 6), (1, 2, 4), (3, 3, 3)
    xs, tb = _sta_inputs(grid, seed=5, b=2)
    ins = [torch.from_numpy(x) for x in xs]
    tbt = torch.from_numpy(tb)
    want = sta.sta_joint_attention(*ins, tbt, grid=grid, tile=tile,
                                   window=window)
    for chunk in (32, 7):
        got = sta.sta_gathered_attention(*ins, tbt, grid=grid, tile=tile,
                                         window=window, tile_chunk=chunk)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    leaves = [x.clone().requires_grad_(True) for x in ins]
    io, to = joint_attention(*leaves, tbt, mode="sta", token_grid=grid,
                             sta_tile=tile, sta_window=window)
    (io.sum() + to.sum()).backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all()
               and x.grad.abs().max() > 0 for x in leaves)


def test_sta_gathered_takes_the_image_key_bias():
    """An image key bias (the ring x STA halo's wrap mask: NEG_INF over a
    t-plane, a different one per batch row) reaches the gathered form as
    it reaches the dispatch, for the image and the text queries, and the
    trainable wrapper's backward gives the masked keys no gradient."""
    grid, tile, window = (3, 5, 6), (1, 2, 4), (3, 3, 3)
    xs, tb = _sta_inputs(grid, seed=6, b=2)
    ins = [torch.from_numpy(x) for x in xs]
    tbt = torch.from_numpy(tb)
    plane = grid[1] * grid[2]
    ikb = torch.zeros(2, grid[0] * plane)
    ikb[0, :plane] = NEG_INF
    ikb[1, -plane:] = NEG_INF
    kw = dict(grid=grid, tile=tile, window=window)
    want = sta.sta_joint_attention(*ins, tbt, img_key_bias=ikb, **kw)
    got = sta.sta_gathered_attention(*ins, tbt, img_key_bias=ikb, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    assert (got[0] - sta.sta_gathered_attention(*ins, tbt, **kw)[0]
            ).abs().max() > 1e-2
    leaves = [x.clone().requires_grad_(True) for x in ins]
    io, to = sta.sta_joint_attention_trainable(
        *leaves, tbt, bound_mode="static", score_bound=torch.tensor(4.0),
        img_key_bias=ikb, **kw)
    (torch.sin(io).sum() + torch.cos(to).sum()).backward()
    for x in leaves[1:3]:     # dK, dV of the masked planes
        assert x.grad[0, :plane].abs().max() == 0
        assert x.grad[1, -plane:].abs().max() == 0
        assert x.grad[0, plane:].abs().max() > 0


# --------------------------------------------------------------------------
# a 1+1-block DiT's loss gradients through the flash VJP
# --------------------------------------------------------------------------

DIT = dict(hidden_size=128, heads_num=1, mm_double_blocks_depth=1,
           mm_single_blocks_depth=1, rope_dim_list=(32, 48, 48),
           text_states_dim=32, text_states_dim_2=16)


def _randomize(tree, rng):
    """Random values for every leaf the init zeroes (adaLN, final layer,
    biases), so every gradient is non-trivial."""
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32) if np.any(np.asarray(a))
                   else rng.standard_normal(np.shape(a)).astype(np.float32)
                   * 0.05), tree)


def test_dit_loss_grads_flash_vs_sdpa_and_jax():
    """flow_match_loss of a 1+1-block DiT: parameter gradients under
    attn_mode="flash" (FlashAttentionVJP) against attn_mode="sdpa" and
    against JAX's flash gradients, each through dit_state_dict_from_jax."""
    rng = np.random.default_rng(6)
    jcfg = JCfg(attn_mode="flash", **DIT)
    params = _randomize(init_dit_params(jax.random.PRNGKey(0), jcfg), rng)
    x0 = rng.standard_normal((1, 16, 2, 4, 4)).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    t = np.full((1,), 0.4, np.float32)
    pe = rng.standard_normal((1, 8, 32)).astype(np.float32)
    mask = np.ones((1, 8), np.int32)
    mask[:, 6:] = 0
    pe2 = rng.standard_normal((1, 16)).astype(np.float32)
    jc, js = jax_rope(jcfg.rope_dim_list, (2, 2, 2), theta=jcfg.rope_theta)

    from hunyuanvideo_efficiency_tpu.models.dit import (
        patchify_raw as jax_patchify)

    jparams = jax.tree.map(jnp.asarray, params)
    want_loss, jgrads = jax.value_and_grad(
        lambda p: jax_flow_match_loss(
            p, jax_patchify(jnp.asarray(x0), jcfg.patch_size),
            jax_patchify(jnp.asarray(noise), jcfg.patch_size),
            jnp.asarray(t), jnp.asarray(pe), jnp.asarray(mask),
            jnp.asarray(pe2), jc, js, None, jcfg))(jparams)
    cfg = DiTConfig(attn_mode="flash", **DIT)
    want = dit_state_dict_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jgrads), cfg)

    tc, ts = get_nd_rotary_pos_embed(cfg.rope_dim_list, (2, 2, 2),
                                     theta=cfg.rope_theta, device="cpu")
    grads, losses = {}, {}
    for mode in ("flash", "sdpa"):
        model = HYVideoDiT(dataclasses.replace(cfg, attn_mode=mode))
        model.load_state_dict(dit_state_dict_from_jax(params, cfg))
        loss = flow_match_loss(
            model, patchify_raw(torch.from_numpy(x0), cfg.patch_size),
            patchify_raw(torch.from_numpy(noise), cfg.patch_size),
            torch.from_numpy(t), torch.from_numpy(pe),
            torch.from_numpy(mask), torch.from_numpy(pe2), tc, ts, None)
        loss.backward()
        losses[mode] = float(loss.detach())
        grads[mode] = {n: p.grad for n, p in model.named_parameters()}
    np.testing.assert_allclose(losses["flash"], float(want_loss), rtol=1e-4)
    np.testing.assert_allclose(losses["flash"], losses["sdpa"], rtol=1e-5)
    assert set(want) == set(grads["flash"])
    moved = 0
    for name, ref in want.items():
        got = grads["flash"][name]
        assert got is not None and got.shape == ref.shape, name
        np.testing.assert_allclose(got.numpy(), grads["sdpa"][name].numpy(),
                                   **TOL, err_msg=f"{name} vs sdpa")
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL,
                                   err_msg=f"{name} vs JAX")
        moved += bool(ref.abs().max() > 1e-6)
    assert moved > 0.9 * len(want)
