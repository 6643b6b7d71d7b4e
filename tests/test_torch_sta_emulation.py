"""The emulations of the port's STA kernels on the CPU (ops/sta.py): B4's
direct walk with zero-filled boxes (`sta_direct_emulate`, bf16 and its
int8 arm B4q), the permuted kernels' walks (`sta_permuted_emulate`: the
running B7, the static B6a/b and its int8 arm B6q) and their tile codes,
each against `sta_attention_plain` / `sta_permuted_plain` and against the
JAX package's interpret-mode kernels. Inputs and tolerance as in
tests/sta_cases.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.ops import sta as jsta
from hunyuanvideo_efficiency_tpu_torch.ops import sta
from hunyuanvideo_efficiency_tpu_torch.ops.flash_attention import (
    int8_bound_inflation)
from sta_cases import NEG_INF, _close, _inputs, _jax, _torch


# the CUDA tests' STA_CASES (grid, tile, window, text keys, valid text keys
# of batch 1) at small widths
EMULATED = [((5, 9, 13), (2, 4, 8), (3, 3, 3), 37, 20),
            ((4, 8, 16), (2, 4, 8), (1, 3, 3), 160, 5),
            ((5, 17, 30), (4, 8, 8), (3, 3, 3), 256, 40)]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", EMULATED, ids=["ragged", "masked_txt",
                                                "main_tile"])
def test_sta_direct_emulation_matches_plain(case, quant):
    """B4's walk with zero-filled boxes and the geometry bias
    (sta_direct_emulate) is the function of sta_attention_plain, with and
    without an image key bias; fp32, sums in another order."""
    grid, tile, window, lt, txt_valid = case
    rng = np.random.default_rng(11)
    b, h, d = 2, 2, 64
    s = grid[0] * grid[1] * grid[2]
    img = [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32) * 0.5) for _ in range(3)]
    tk, tv = (torch.from_numpy(rng.standard_normal((b, lt, h, d)).astype(
        np.float32) * 0.5) for _ in range(2))
    tb = torch.zeros(b, 1, 1, lt)
    tb[1, ..., txt_valid:] = NEG_INF
    ikb = torch.from_numpy(np.where(rng.random((b, s)) > 0.2, 0.0, NEG_INF)
                           .astype(np.float32))
    c = torch.full((b, h), 3.0)
    for kb in (None, ikb):
        got = sta.sta_direct_emulate(*img, tk, tv, tb, c, grid, tile, window,
                                     d ** -0.5, kb, quant)
        want = sta.sta_attention_plain(*img, tk, tv, tb, grid, tile, window,
                                       d ** -0.5, c, kb, qk_int8=quant)
        _close(got, want)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_sta_direct_emulation_matches_jax_kernel(quant):
    """The walk against JAX's _sta_nomax_direct_kernel in interpret mode
    (sta_joint_attention's static direct arm) on a ragged grid of 64-token
    tiles, whose key chunks pair two tiles."""
    grid, tile, window, lt, _ = EMULATED[0]
    img, txt, tb, ikb = _inputs(grid, seed=12, d=64, lt=lt, key_bias=True)
    bound = 2.0
    kw = dict(grid=grid, tile=tile, window=window, bound_mode="static",
              qk_int8=quant)
    want, _ = jsta.sta_joint_attention(*_jax(*img, *txt, tb), **kw,
                                       img_key_bias=_jax(ikb)[0],
                                       score_bound=jnp.float32(bound))
    d = img[0].shape[-1]
    c = torch.full((2, 2), bound * (int8_bound_inflation(d) if quant
                                    else 1.0))
    iq, ik, iv, _, tk, tv, tbt, kb = _torch(*img, *txt, tb, ikb)
    got = sta.sta_direct_emulate(iq, ik, iv, tk, tv, tbt, c, grid, tile,
                                 window, d ** -0.5, kb, quant)
    _close(got, want)


def test_sta_tile_codes_plain_is_tile_codes():
    """B4q's pre-pass layout: the row-major codes, moved back to tile-major
    order with the rows past the grid zero, are tile_codes' bit for bit,
    and the scales are its scales; on CPU tensors the wrapper is the plain
    version."""
    grid, tile, window = (5, 9, 13), (2, 4, 8), (3, 3, 3)
    rng = np.random.default_rng(13)
    q, k = (torch.from_numpy(rng.standard_normal((2, 585, 3, 64)).astype(
        np.float32)).bfloat16() for _ in range(2))
    q8, k8, sq, sk = sta.sta_tile_codes(q, k, grid, tile)
    plan = sta.tile_plan(grid, tile, window, 0)
    for x, codes, scales in ((q, q8, sq), (k, k8, sk)):
        want, want_sc = sta.tile_codes(
            sta._permute_tokens(x, grid, tile, plan), 64)
        got = sta._permute_tokens(codes.reshape(2, 585, 3, 64), grid, tile,
                                  plan)
        assert codes.dtype == torch.int8 and codes.shape == (2, 585, 192)
        assert torch.equal(got.float(), want.reshape(got.shape))
        assert torch.equal(scales, want_sc.permute(0, 2, 1))


# B7's emulation cases (grid, tile, window, text keys, valid text keys of
# batch 1): a ragged grid of 64-token tiles, fully masked text boxes, the
# main-path tile whose last frame row has query boxes of pure padding
PERMUTED_EMULATED = [((5, 9, 13), (2, 4, 8), (3, 3, 3), 37, 20),
                     ((4, 8, 16), (2, 4, 8), (1, 3, 3), 160, 5),
                     ((5, 17, 30), (4, 8, 8), (3, 3, 3), 256, 40)]


@pytest.mark.parametrize("case", PERMUTED_EMULATED,
                         ids=["ragged", "masked_txt", "main_tile"])
def test_sta_permuted_emulation_matches_plain(case):
    """B7's walk with its all-masked box skip, the online softmax in walk
    order and zeroed padding rows (sta_permuted_emulate) is the function of
    sta_permuted_plain's running arm (c=None), padding rows included, with
    and without an image key bias; fp32, sums in another order."""
    grid, tile, window, lt, txt_valid = case
    rng = np.random.default_rng(21)
    b, h, d = 2, 2, 64
    s = grid[0] * grid[1] * grid[2]
    img = [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32) * 0.5) for _ in range(3)]
    tk, tv = (torch.from_numpy(rng.standard_normal((b, lt, h, d)).astype(
        np.float32) * 0.5) for _ in range(2))
    tb = torch.zeros(b, 1, 1, lt)
    tb[1, ..., txt_valid:] = NEG_INF
    ikb = torch.from_numpy(np.where(rng.random((b, s)) > 0.2, 0.0, NEG_INF)
                           .astype(np.float32))
    for kb_img in (None, ikb):
        _, qp, kcat, vcat, kb = sta.permuted_operands(
            *img, tk, tv, tb, grid, tile, window, kb_img)
        got = sta.sta_permuted_emulate(qp, kcat, vcat, kb, grid, tile,
                                       window, d ** -0.5)
        want = sta.sta_permuted_plain(qp, kcat, vcat, kb, grid, tile, window,
                                      d ** -0.5)
        _close(got, want)


def test_sta_permuted_emulation_matches_jax_kernel():
    """The walk against JAX's _sta_kernel in interpret mode (the running
    arm of sta_joint_attention, bound_mode="auto") on a ragged grid of
    64-token tiles, whose key chunks pair two boxes, with an image key
    bias."""
    grid, tile, window, lt, _ = PERMUTED_EMULATED[0]
    img, txt, tb, ikb = _inputs(grid, seed=22, d=64, lt=lt, key_bias=True)
    kw = dict(grid=grid, tile=tile, window=window, bound_mode="auto")
    want, _ = jsta.sta_joint_attention(*_jax(*img, *txt, tb), **kw,
                                       img_key_bias=_jax(ikb)[0])
    iq, ik, iv, _, tk, tv, tbt, kb_img = _torch(*img, *txt, tb, ikb)
    plan, qp, kcat, vcat, kb = sta.permuted_operands(
        iq, ik, iv, tk, tv, tbt, grid, tile, window, kb_img)
    got = sta.sta_permuted_emulate(qp, kcat, vcat, kb, grid, tile, window,
                                   64 ** -0.5)
    _close(sta._unpermute_tokens(got, grid, plan), want)


@pytest.mark.parametrize("quant", [False, True], ids=["static", "int8"])
@pytest.mark.parametrize("case", PERMUTED_EMULATED,
                         ids=["ragged", "masked_txt", "main_tile"])
def test_sta_permuted_static_emulation_matches_plain(case, quant):
    """B6a/B6b's and B6q's walk (sta_permuted_emulate with c: the static
    offset, under quant the codes of tile_codes with each key's own tile's
    scale) is the function of sta_permuted_plain's static arm (and its
    qk_int8 arm), padding rows included, with and without an image key
    bias; fp32, sums in another order."""
    grid, tile, window, lt, txt_valid = case
    rng = np.random.default_rng(23)
    b, h, d = 2, 2, 64
    s = grid[0] * grid[1] * grid[2]
    img = [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32) * 0.5) for _ in range(3)]
    tk, tv = (torch.from_numpy(rng.standard_normal((b, lt, h, d)).astype(
        np.float32) * 0.5) for _ in range(2))
    tb = torch.zeros(b, 1, 1, lt)
    tb[1, ..., txt_valid:] = NEG_INF
    ikb = torch.from_numpy(np.where(rng.random((b, s)) > 0.2, 0.0, NEG_INF)
                           .astype(np.float32))
    c = torch.tensor([[3.0, 2.5], [2.0, 3.5]])
    for kb_img in (None, ikb):
        _, qp, kcat, vcat, kb = sta.permuted_operands(
            *img, tk, tv, tb, grid, tile, window, kb_img)
        got = sta.sta_permuted_emulate(qp, kcat, vcat, kb, grid, tile,
                                       window, d ** -0.5, c, quant)
        want = sta.sta_permuted_plain(qp, kcat, vcat, kb, grid, tile, window,
                                      d ** -0.5, c, qk_int8=quant)
        _close(got, want)


@pytest.mark.parametrize("quant", [False, True], ids=["static", "int8"])
@pytest.mark.parametrize("arm", [dict(direct=False), dict(fused=False)],
                         ids=["fused", "unfused"])
def test_sta_permuted_static_emulation_matches_jax_kernel(arm, quant):
    """The static walk against JAX's _sta_nomax_fused_kernel (direct=False)
    and _sta_nomax_kernel (fused=False) in interpret mode, and their
    quant=True arm, through sta_joint_attention(bound_mode="static"), on a
    ragged grid of 64-token tiles, whose key chunks pair two boxes (under
    quant of two tiles with their own scales), with an image key bias; the
    int8 codes agree exactly, so the fp32 tolerance holds."""
    grid, tile, window, lt, _ = PERMUTED_EMULATED[0]
    img, txt, tb, ikb = _inputs(grid, seed=24, d=64, lt=lt, key_bias=True)
    bound = 2.0
    want, _ = jsta.sta_joint_attention(
        *_jax(*img, *txt, tb), grid=grid, tile=tile, window=window,
        bound_mode="static", qk_int8=quant, img_key_bias=_jax(ikb)[0],
        score_bound=jnp.float32(bound), **arm)
    c = torch.full((2, 2), bound * (int8_bound_inflation(64) if quant
                                    else 1.0))
    iq, ik, iv, _, tk, tv, tbt, kb_img = _torch(*img, *txt, tb, ikb)
    plan, qp, kcat, vcat, kb = sta.permuted_operands(
        iq, ik, iv, tk, tv, tbt, grid, tile, window, kb_img)
    got = sta.sta_permuted_emulate(qp, kcat, vcat, kb, grid, tile, window,
                                   64 ** -0.5, c, quant)
    _close(sta._unpermute_tokens(got, grid, plan), want)


def test_sta_permuted_codes_on_cpu_are_tile_codes():
    """B6q's pre-pass wrapper on CPU tensors: tile_codes of qp and kcat in
    the kernel's layout, codes [B, rows, H*D] int8 and scales [B, H,
    tiles]; the text blocks are tiles of their own. Off the CPU it launches
    the kernel or raises."""
    grid, tile, window, lt, _ = PERMUTED_EMULATED[0]
    img, txt, tb, _ = _inputs(grid, seed=25, d=64, lt=lt)
    iq, ik, iv, _, tk, tv, tbt = _torch(*img, *txt, tb)
    _, qp, kcat, _, _ = sta.permuted_operands(iq, ik, iv, tk, tv, tbt, grid,
                                              tile, window)
    q8, k8, sq, sk = sta.sta_permuted_codes(qp.bfloat16(), kcat.bfloat16(),
                                            tile)
    b, s_pad, h, d = qp.shape
    assert q8.dtype == k8.dtype == torch.int8
    assert q8.shape == (b, s_pad, h * d) and sq.shape == (b, h, s_pad // 64)
    assert k8.shape == (b, kcat.shape[1], h * d)
    assert sk.shape == (b, h, kcat.shape[1] // 64)
    for x, codes, scales in ((qp, q8, sq), (kcat, k8, sk)):
        want, want_sc = sta.tile_codes(x.bfloat16(), 64)
        assert torch.equal(codes.float(), want.reshape(codes.shape))
        assert torch.equal(scales, want_sc.permute(0, 2, 1))
    meta = qp.bfloat16().to("meta")   # neither CPU nor CUDA: it raises
    with pytest.raises(ValueError, match="CUDA"):
        sta.sta_permuted_codes(meta, meta, tile)
