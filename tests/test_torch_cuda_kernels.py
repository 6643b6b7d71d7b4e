"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked `cuda`: without a CUDA device they skip (the decision is
made inside the fixture). Run them on a GPU host with
`python -m pytest tests/test_torch_cuda_kernels.py -q`.

Tolerances: bf16/fp16 outputs of O(1) values, one rounding of the output
plus fp32 sums in another order: 1e-2 absolute.
"""
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu_torch.ops.conv3d_cuda import (
    conv3d_stride1, conv3d_stride1_plain, conv3d_stride1_v2)
from hunyuanvideo_efficiency_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_plain, flash_running, flash_static,
    merge_flash_states)
from hunyuanvideo_efficiency_tpu_torch.ops.sta import ring_geometry_ok

pytestmark = pytest.mark.cuda
TOL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (batch, query rows, keys, head_dim, masked keys of the last batch entry,
# v a column view of a fused [B, S, 3*H*D] projection)
FLASH_CASES = [
    (2, 200, 200, 128, 13, False),
    (2, 77, 77, 64, 13, False),
    (2, 1000, 1000, 128, 13, False),
    (2, 4288, 4272, 128, 13, True),    # ragged against 128-row tiles
    (2, 200, 1000, 128, 13, False),
    (2, 256, 256, 128, 216, False),    # the text keys alone, 216 padded
    (2, 200, 100, 64, 60, True),       # fewer keys than one tile
    (1, 256, 34680, 128, 13, True),    # the key-range split, B = 1
    (2, 256, 34680, 64, 13, False),    # the split, D = 64
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,sq,sk,d,masked,fused_v", FLASH_CASES)
@pytest.mark.parametrize("running", [False, True])
def test_flash_kernel_matches_plain(dev, dtype, b, sq, sk, d, masked,
                                    fused_v, running):
    """K1/K2 with their (m, l) state, and for the running kernel B5f's
    output and lse, against the plain versions; one launch counted a call,
    the key-range split included."""
    from hunyuanvideo_efficiency_tpu_torch.ops import flash_backward as fb

    g = torch.Generator(dev).manual_seed(0)
    h = 3
    q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, sk, h, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, sk, h, d, generator=g, device=dev).to(dtype)
    q = torch.nn.functional.normalize(q.float(), dim=-1).to(dtype) * 4
    k = torch.nn.functional.normalize(k.float(), dim=-1).to(dtype) * 4
    if fused_v:
        fused = torch.zeros(b, sk, 3, h, d, dtype=dtype, device=dev)
        fused[:, :, 2] = v
        v = fused[:, :, 2]
        assert not v.is_contiguous()
    kb = torch.zeros(b, sk, device=dev)
    kb[b - 1, sk - masked:] = -1e30
    c = torch.full((b, h), 16.0 * d ** -0.5 * 1.02, device=dev)
    scale = d ** -0.5
    n0 = (flash_static.LAUNCHES, flash_running.LAUNCHES,
          fb.flash_fwd_lse.LAUNCHES)
    if running:
        out = flash_running(q, k, v, kb, scale, return_state=True)
        lse_out = fb.flash_fwd_lse(q, k, v, kb, scale)
        lse_ref = fb.flash_fwd_lse_plain(q, k, v, kb, scale)
    else:
        out = flash_static(q, k, v, kb, c, scale, return_state=True)
    ref = flash_attention_plain(q, k, v, kb, c, scale, running, True)
    torch.cuda.synchronize()
    assert (flash_static.LAUNCHES, flash_running.LAUNCHES,
            fb.flash_fwd_lse.LAUNCHES) == \
        ((n0[0], n0[1] + 1, n0[2] + 1) if running else
         (n0[0] + 1, n0[1], n0[2]))
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        torch.testing.assert_close(o.float(), r.float(), atol=TOL, rtol=TOL)
    if running:
        torch.testing.assert_close(lse_out[0].float(), lse_ref[0].float(),
                                   atol=TOL, rtol=TOL)
        torch.testing.assert_close(lse_out[1], lse_ref[1], atol=2e-3,
                                   rtol=1e-4)


@pytest.mark.parametrize("bound_mode", ["static", "running"])
@pytest.mark.parametrize("nq,nk,cut", [(100, 333, 77), (256, 34936, 34680)],
                         ids=["short", "text-merge"])
def test_flash_kernel_split_keys_merge(dev, bound_mode, nq, nk, cut):
    """Queries against two key sets of other lengths, no key bias, with
    state; the merged states equal attention over all keys. The second
    case is the STA text merge's shape: 256 text queries over the image
    keys (the kernel's key-range split) and then over 256 text keys."""
    g = torch.Generator(dev).manual_seed(2)
    q, k, v = (torch.randn(1, n, 4, 128, generator=g, device=dev)
               .bfloat16() for n in (nq, nk, nk))
    halves = [flash_attention(q, k[:, sl], v[:, sl], bound_mode=bound_mode,
                              return_state=True)
              for sl in (slice(0, cut), slice(cut, None))]
    for (o, m, l), sl in zip(halves, (slice(0, cut), slice(cut, None))):
        ref = flash_attention(q.cpu().float(), k[:, sl].cpu().float(),
                              v[:, sl].cpu().float(), bound_mode=bound_mode,
                              return_state=True)
        for x, r in zip((o, m, l), ref):
            torch.testing.assert_close(x.float().cpu(), r, atol=TOL,
                                       rtol=TOL)
    merged = merge_flash_states(*halves)[0]
    full = flash_attention(q, k, v, bound_mode="running")
    torch.cuda.synchronize()
    torch.testing.assert_close(merged.float(), full.float(), atol=TOL,
                               rtol=TOL)


# Shapes at the edges of the kernels' 256-pixel tiles (conv_tile picks its
# width): H and W not multiples of the tile, W under one tile (6 < 8), a
# frame smaller than one tile, the decoder's 512 -> 512 stage at 32x32x9,
# and T = 1.
CONV_EDGE_SHAPES = [(1, 2, 17, 33, 128, 128),
                    (1, 2, 20, 6, 128, 128),
                    (1, 3, 5, 7, 128, 128),
                    (1, 9, 32, 32, 512, 512),
                    (1, 1, 16, 16, 128, 256)]


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 3, 8, 16, 128, 128),
                                   (2, 2, 13, 21, 256, 128),
                                   (1, 2, 9, 9, 128, 256)]
                         + CONV_EDGE_SHAPES)
def test_conv3d_kernel_matches_plain(dev, dtype, shape):
    b, t, h, w, cin, cout = shape
    g = torch.Generator(dev).manual_seed(1)
    xp = torch.randn(b, t + 2, h + 2, w + 2, cin, generator=g,
                     device=dev).to(dtype)
    kern = (torch.randn(3, 3, 3, cin, cout, generator=g, device=dev)
            / (27 * cin) ** 0.5).to(dtype)
    bias = torch.randn(cout, generator=g, device=dev).to(dtype)
    n0 = conv3d_stride1.LAUNCHES
    out = conv3d_stride1(xp, kern, bias)
    ref = conv3d_stride1_plain(xp, kern, bias)
    torch.cuda.synchronize()
    assert conv3d_stride1.LAUNCHES == n0 + 1
    torch.testing.assert_close(out.float(), ref.float(), atol=2 * TOL,
                               rtol=TOL)


# The VAE encoder's K3 shapes at 240x432x33 (conv_probe.roundtrip_k3_shapes):
# under the all-off t-ops config, under the first `pool` config (T halved in
# down block 0), and T = 1 and 2 as stacked pools leave them.
CONV_ENCODER_SHAPES = [(1, 33, 240, 432, 128, 128),
                       (1, 33, 120, 216, 128, 256),
                       (1, 33, 120, 216, 256, 256),
                       (1, 17, 60, 108, 256, 512),
                       (1, 17, 60, 108, 512, 512),
                       (1, 9, 30, 54, 512, 512),
                       (1, 17, 240, 432, 128, 128),
                       (1, 17, 120, 216, 128, 256),
                       (1, 17, 120, 216, 256, 256),
                       (1, 9, 60, 108, 256, 512),
                       (1, 9, 60, 108, 512, 512),
                       (1, 5, 30, 54, 512, 512),
                       (1, 1, 240, 432, 128, 128),
                       (1, 2, 120, 216, 256, 256),
                       (1, 1, 60, 108, 256, 512),
                       (1, 2, 30, 54, 512, 512)]


@pytest.mark.parametrize("shape", CONV_ENCODER_SHAPES)
def test_conv3d_kernel_at_encoder_shapes(dev, shape):
    """K3 (fp16, with a bias) against F.conv3d on the same padded input,
    max relative error 5e-3 of the output's largest magnitude, as the
    smoke's conv checks."""
    b, t, h, w, cin, cout = shape
    g = torch.Generator(dev).manual_seed(13)
    xp = torch.randn(b, t + 2, h + 2, w + 2, cin, generator=g,
                     device=dev).half()
    kern = (torch.randn(3, 3, 3, cin, cout, generator=g, device=dev)
            / (27 * cin) ** 0.5).half()
    bias = torch.randn(cout, generator=g, device=dev).half()
    n0 = conv3d_stride1.LAUNCHES
    out = conv3d_stride1(xp, kern, bias).float()
    ref = torch.nn.functional.conv3d(
        xp.permute(0, 4, 1, 2, 3), kern.permute(4, 3, 0, 1, 2), bias
    ).permute(0, 2, 3, 4, 1).float()
    torch.cuda.synchronize()
    assert conv3d_stride1.LAUNCHES == n0 + 1 and out.shape == ref.shape
    assert (out - ref).abs().max() <= 5e-3 * ref.abs().max()


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 3, 8, 16, 128, 128),
                                   (2, 2, 13, 21, 256, 128),
                                   (1, 2, 9, 9, 128, 256),
                                   (1, 1, 8, 16, 128, 128),
                                   (2, 3, 10, 20, 128, 128),
                                   (1, 7, 17, 9, 256, 256)]
                         + CONV_EDGE_SHAPES)
def test_conv3d_v2_kernel_matches_plain_and_k3(dev, dtype, shape):
    """B11 against the plain version and against K3 on the same input: K3's
    test shapes, T = 1, 2 and 3 (a sweep shorter than the three taps), a
    longer one with ragged H and W tiles and the tile-edge shapes. Both sum
    each output's terms in the same order, so B11 equals K3 bit for bit."""
    b, t, h, w, cin, cout = shape
    g = torch.Generator(dev).manual_seed(11)
    xp = torch.randn(b, t + 2, h + 2, w + 2, cin, generator=g,
                     device=dev).to(dtype)
    kern = (torch.randn(3, 3, 3, cin, cout, generator=g, device=dev)
            / (27 * cin) ** 0.5).to(dtype)
    bias = torch.randn(cout, generator=g, device=dev).to(dtype)
    n0 = (conv3d_stride1_v2.LAUNCHES, conv3d_stride1.LAUNCHES)
    out = conv3d_stride1_v2(xp, kern, bias)
    k3 = conv3d_stride1(xp, kern, bias)
    ref = conv3d_stride1_plain(xp, kern, bias)
    torch.cuda.synchronize()
    assert (conv3d_stride1_v2.LAUNCHES, conv3d_stride1.LAUNCHES) == \
        (n0[0] + 1, n0[1] + 1)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=2 * TOL,
                               rtol=TOL)
    torch.testing.assert_close(out.float(), k3.float(), atol=2 * TOL,
                               rtol=TOL)
    assert torch.equal(out, k3)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 3, 8, 16, 128, 128),
                                   (1, 2, 17, 33, 128, 128)])
def test_conv3d_kernels_without_bias(dev, dtype, shape):
    """K3 and B11 with no bias against the plain version, B11 equal to K3."""
    b, t, h, w, cin, cout = shape
    g = torch.Generator(dev).manual_seed(12)
    xp = torch.randn(b, t + 2, h + 2, w + 2, cin, generator=g,
                     device=dev).to(dtype)
    kern = (torch.randn(3, 3, 3, cin, cout, generator=g, device=dev)
            / (27 * cin) ** 0.5).to(dtype)
    out = conv3d_stride1(xp, kern)
    v2 = conv3d_stride1_v2(xp, kern)
    ref = conv3d_stride1_plain(xp, kern)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2 * TOL,
                               rtol=TOL)
    assert torch.equal(v2, out)


def _sta_inputs(dev, dtype, grid, d, lt, txt_valid, seed=3):
    """Row-major STA inputs: unit-norm q/k times 4 (|s| <= 16/sqrt(d)), the
    static offset that bounds them, text keys of which `txt_valid` are
    unmasked in batch 1 (all in batch 0)."""
    g = torch.Generator(dev).manual_seed(seed)
    b, h, s = 2, 3, grid[0] * grid[1] * grid[2]

    def qk(n):
        x = torch.randn(b, n, h, d, generator=g, device=dev)
        return (torch.nn.functional.normalize(x, dim=-1) * 4).to(dtype)

    img = [qk(s), qk(s), torch.randn(b, s, h, d, generator=g,
                                     device=dev).to(dtype)]
    txt = [qk(lt), qk(lt), torch.randn(b, lt, h, d, generator=g,
                                       device=dev).to(dtype)]
    tb = torch.zeros(b, 1, 1, lt, device=dev)
    tb[1, ..., txt_valid:] = -1e30
    c = torch.full((b, h), 16.0 * d ** -0.5 * 1.02, device=dev)
    return img, txt, tb, c


STA_CASES = [
    # grid, tile, window, text keys, valid text keys of batch 1
    ((5, 9, 13), (2, 4, 8), (3, 3, 3), 37, 20),     # ragged on every axis
    ((4, 8, 16), (2, 4, 8), (1, 3, 3), 160, 5),     # fully masked text chunks
    ((5, 17, 30), (4, 8, 8), (3, 3, 3), 256, 40),   # main-path tile, ragged
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", STA_CASES)
def test_sta_kernels_match_plain(dev, dtype, d, case):
    from hunyuanvideo_efficiency_tpu_torch.ops import sta

    grid, tile, window, lt, txt_valid = case
    (iq, ik, iv), (_, tk, tv), tb, c = _sta_inputs(dev, dtype, grid, d, lt,
                                                   txt_valid)
    scale = d ** -0.5
    ikb = torch.zeros(iq.shape[:2], device=dev)
    ikb[0, ::7] = -1e30                                # caller key mask
    plan, qp, kcat, vcat, kb = sta.permuted_operands(
        iq, ik, iv, tk, tv, tb, grid, tile, window)
    n0 = (sta.sta_direct.LAUNCHES, sta.sta_permuted_static.LAUNCHES,
          sta.sta_permuted_running.LAUNCHES)
    got = {
        "direct": sta.sta_direct(iq, ik, iv, tk, tv, tb, c, grid, tile,
                                 window, scale),
        "direct_kb": sta.sta_direct(iq, ik, iv, tk, tv, tb, c, grid, tile,
                                    window, scale, img_key_bias=ikb),
        "static": sta._unpermute_tokens(sta.sta_permuted_static(
            qp, kcat, vcat, kb, c, grid, tile, window, scale), grid, plan),
        "running": sta._unpermute_tokens(sta.sta_permuted_running(
            qp, kcat, vcat, kb, grid, tile, window, scale), grid, plan),
    }
    ref = {
        "direct": sta.sta_attention_plain(iq, ik, iv, tk, tv, tb, grid, tile,
                                          window, scale, c),
        "direct_kb": sta.sta_attention_plain(iq, ik, iv, tk, tv, tb, grid,
                                             tile, window, scale, c, ikb),
        "static": sta.sta_attention_plain(iq, ik, iv, tk, tv, tb, grid, tile,
                                          window, scale, c),
        "running": sta.sta_attention_plain(iq, ik, iv, tk, tv, tb, grid,
                                           tile, window, scale),
    }
    torch.cuda.synchronize()
    assert (sta.sta_direct.LAUNCHES, sta.sta_permuted_static.LAUNCHES,
            sta.sta_permuted_running.LAUNCHES) == (n0[0] + 2, n0[1] + 1,
                                                   n0[2] + 1)
    for name, out in got.items():
        assert out.dtype == dtype and out.shape == ref[name].shape, name
        torch.testing.assert_close(out.float(), ref[name].float(), atol=TOL,
                                   rtol=TOL, msg=name)
    # the permuted kernels store padding rows as zeros, as the plain does
    padded = sta.sta_permuted_static(qp, kcat, vcat, kb, c, grid, tile,
                                     window, scale)
    plain = sta.sta_permuted_plain(qp, kcat, vcat, kb, grid, tile, window,
                                   scale, c)
    torch.testing.assert_close(padded.float(), plain.float(), atol=TOL,
                               rtol=TOL)


# B4 / B4q beyond STA_CASES: (grid, tile, window, text keys, valid text keys
# of batch 1). Text lengths 1, 127, 129 and 256 against 128-key chunks (B4q:
# 64), every text key of batch 1 masked (no text chunk walked); T = 5 of
# 4-frame tiles, so the last tile's second 128-row query box lies wholly
# past T; a 64-token tile whose last key chunk repeats its box.
DIRECT_CASES = [
    ((5, 17, 30), (4, 8, 8), (3, 3, 3), 1, 1),
    ((5, 17, 30), (4, 8, 8), (3, 3, 3), 64, 0),
    ((5, 17, 30), (4, 8, 8), (3, 3, 3), 127, 100),
    ((6, 16, 24), (4, 8, 8), (3, 3, 3), 129, 129),
    ((9, 10, 19), (2, 4, 8), (3, 3, 3), 256, 3),
]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", DIRECT_CASES)
def test_sta_direct_kernels_edges(dev, dtype, case, quant):
    """B4 and B4q (csrc/sta_direct.cu) against sta_attention_plain with an
    image key bias and v a column view of a fused [B, S, 3, H, D]
    projection; two runs equal bit for bit; one launch counted a call."""
    from hunyuanvideo_efficiency_tpu_torch.ops import sta
    from hunyuanvideo_efficiency_tpu_torch.ops.flash_attention import (
        int8_bound_inflation)

    grid, tile, window, lt, txt_valid = case
    d = 128
    (iq, ik, iv), (_, tk, tv), tb, c = _sta_inputs(dev, dtype, grid, d, lt,
                                                   txt_valid, seed=14)
    fused = torch.zeros(*iv.shape[:2], 3, *iv.shape[2:], dtype=dtype,
                        device=dev)
    fused[:, :, 2] = iv
    iv = fused[:, :, 2]
    assert not iv.is_contiguous()
    if quant:
        c = c * int8_bound_inflation(d)
    ikb = torch.zeros(iq.shape[:2], device=dev)
    ikb[1, ::5] = -1e30
    ikb[0, 3::7] = -0.5
    scale = d ** -0.5
    fn = sta.sta_direct_int8 if quant else sta.sta_direct
    n0 = fn.LAUNCHES
    out = fn(iq, ik, iv, tk, tv, tb, c, grid, tile, window, scale, ikb)
    again = fn(iq, ik, iv, tk, tv, tb, c, grid, tile, window, scale, ikb)
    ref = sta.sta_attention_plain(iq, ik, iv, tk, tv, tb, grid, tile, window,
                                  scale, c, ikb, qk_int8=quant)
    torch.cuda.synchronize()
    assert fn.LAUNCHES == n0 + 2
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("grid,tile", [((5, 17, 30), (4, 8, 8)),
                                       ((5, 9, 13), (2, 4, 8)),
                                       ((17, 34, 60), (4, 8, 8))])
def test_sta_tile_codes_equal_plain(dev, dtype, grid, tile):
    """B4q's pre-pass against sta_tile_codes_plain (tile_codes in row-major
    order) bit for bit: codes, scales, and in tile-major order the zero rows
    past the grid; k a strided view."""
    from hunyuanvideo_efficiency_tpu_torch.ops import sta

    g = torch.Generator(dev).manual_seed(15)
    b, h, d = 2, 3, 128
    s = grid[0] * grid[1] * grid[2]
    q = torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, s, 2, h, d, generator=g, device=dev).to(dtype)[:, :, 1]
    q8, k8, sq, sk = sta.sta_tile_codes(q, k, grid, tile)
    torch.cuda.synchronize()
    plan = sta.tile_plan(grid, tile, (1, 1, 1), 0)
    for x, codes, scales in ((q, q8, sq), (k, k8, sk)):
        want, want_sc = sta.sta_tile_codes_plain(x, grid, tile)
        assert torch.equal(codes, want) and torch.equal(scales, want_sc)
        tiles, _ = sta.tile_codes(sta._permute_tokens(x, grid, tile, plan),
                                  plan["tokens_per_tile"])
        got = sta._permute_tokens(codes.reshape(b, s, h, d), grid, tile,
                                  plan)
        assert torch.equal(got.float(), tiles.reshape(got.shape))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_sta_direct_at_the_540p_shape(dev, quant):
    """B4 / B4q at the STA main path's shape, [2, 34680, 24, 128] bf16 on
    the 17x34x60 grid with 256 text keys (40 valid), against the plain
    version: max error relative to the output's scale 2e-2."""
    from hunyuanvideo_efficiency_tpu_torch.ops import sta
    from hunyuanvideo_efficiency_tpu_torch.ops.flash_attention import (
        int8_bound_inflation)

    grid, tile, window = (17, 34, 60), (4, 8, 8), (3, 3, 3)
    g = torch.Generator(dev).manual_seed(16)
    b, h, d, lt = 2, 24, 128, 256
    s = grid[0] * grid[1] * grid[2]

    def normed(n):
        x = torch.randn(b, n, h, d, generator=g, device=dev)
        return (x * torch.rsqrt(x.square().mean(-1, keepdim=True))).bfloat16()

    iq, ik, tk = normed(s), normed(s), normed(lt)
    iv, tv = (torch.randn(b, n, h, d, generator=g, device=dev).bfloat16()
              for n in (s, lt))
    tb = torch.zeros(b, 1, 1, lt, device=dev)
    tb[..., 40:] = -1e30
    c = torch.full((b, h), d ** 0.5, device=dev)   # |q.k| * scale <= sqrt(d)
    if quant:
        c = c * int8_bound_inflation(d)
    fn = sta.sta_direct_int8 if quant else sta.sta_direct
    out = fn(iq, ik, iv, tk, tv, tb, c, grid, tile, window, d ** -0.5)
    ref = sta.sta_attention_plain(iq, ik, iv, tk, tv, tb, grid, tile, window,
                                  d ** -0.5, c, qk_int8=quant)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert torch.isfinite(out).all() and err < 2e-2


def test_conv_cuda_impl_rejects_fp32(dev):
    """causal_conv3d(impl="cuda") keeps K3 for fp32, and K3 refuses it."""
    from hunyuanvideo_efficiency_tpu_torch.ops.conv3d import causal_conv3d

    x = torch.zeros(1, 3, 8, 8, 128, device=dev)
    with pytest.raises(TypeError, match="fp16 or bf16"):
        causal_conv3d(x, torch.zeros(3, 3, 3, 128, 128, device=dev),
                      impl="cuda")


def test_fp32_vae_decode_on_the_card(dev):
    """--vae-precision fp32: a small VAE whose convs lie inside K3's gate
    decodes in fp32 on the card through F.conv3d (cuDNN with TF32 off: the
    reference's fp32), no K3 launch, within 1e-3 of the CPU decode relative
    to the output scale; in fp16 the same convs take K3."""
    from hunyuanvideo_efficiency_tpu_torch.models.vae import (
        AutoencoderKLCausal3D)
    from hunyuanvideo_efficiency_tpu_torch.models.vae_config import (
        VAEConfig)

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    vae = AutoencoderKLCausal3D(VAEConfig(
        block_out_channels=(128, 128, 128, 128), layers_per_block=1,
        sample_size=32, sample_tsize=8)).eval()
    z = torch.randn(1, 16, 2, 4, 4)
    with torch.no_grad():
        ref = vae.decode(z)
        n0 = conv3d_stride1.LAUNCHES
        out = vae.to(dev).decode(z.to(dev))
        torch.cuda.synchronize()
        assert conv3d_stride1.LAUNCHES == n0
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
        torch.testing.assert_close(out.cpu(), ref, rtol=1e-3,
                                   atol=1e-3 * ref.abs().max().item())
        vae.half().decode(z.to(dev).half())
        torch.cuda.synchronize()
        assert conv3d_stride1.LAUNCHES > n0


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128),
                                     (torch.bfloat16, 32)])
def test_attention_auto_outside_the_flash_gate(dev, dtype, d):
    """attention(mode="auto") on fp32 or head_dim 32 takes sdpa on the
    card (no flash launch) and equals it; an explicit "flash" raises."""
    from hunyuanvideo_efficiency_tpu_torch.ops.attention import (
        attention, sdpa_attention)

    g = torch.Generator(dev).manual_seed(17)
    q, k, v = (torch.randn(2, 300, 3, d, generator=g, device=dev).to(dtype)
               for _ in range(3))
    kb = torch.zeros(2, 1, 1, 300, device=dev)
    kb[1, ..., 250:] = -1e30
    n0 = (flash_static.LAUNCHES, flash_running.LAUNCHES)
    out = attention(q, k, v, mode="auto", key_bias=kb)
    torch.cuda.synchronize()
    assert (flash_static.LAUNCHES, flash_running.LAUNCHES) == n0
    torch.testing.assert_close(out, sdpa_attention(q, k, v, bias=kb),
                               rtol=0, atol=0)
    with pytest.raises((TypeError, ValueError)):
        attention(q, k, v, mode="flash", key_bias=kb)


# the STA_CASES that pass the ring gate (gh >= wh, ww >= 2), and one with
# a (1, 3, 3) window whose two w-tiles leave a column out at each edge
RING_CASES = [c for c in STA_CASES if ring_geometry_ok(*c[:3])] + [
    ((4, 12, 16), (2, 4, 8), (1, 3, 3), 64, 30)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", RING_CASES)
def test_sta_ring_kernel_matches_plain_and_direct(dev, dtype, d, case):
    """B10 on its w-major operands against sta_ring_plain, and against B4
    (sta_direct, the same function for odd windows) on the row-major
    inputs."""
    from hunyuanvideo_efficiency_tpu_torch.ops import sta

    grid, tile, window, lt, txt_valid = case
    (iq, ik, iv), (_, tk, tv), tb, c = _sta_inputs(dev, dtype, grid, d, lt,
                                                   txt_valid, seed=9)
    b, s, h, _ = iq.shape
    scale = d ** -0.5
    pg = sta._padded_grid(grid, tile)
    kp = sta._permute_tokens_cols(ik, grid, tile, pg)
    vp = sta._permute_tokens_cols(iv, grid, tile, pg)
    args = (iq.reshape(b, *grid, h * d), kp, vp, tk.reshape(b, lt, h * d),
            tv.reshape(b, lt, h * d), tb.reshape(b, lt), c, grid, tile,
            window, scale)
    n0 = sta.sta_ring.LAUNCHES
    out = sta.sta_ring(*args)
    ref = sta.sta_ring_plain(*args)
    direct = sta.sta_direct(iq, ik, iv, tk, tv, tb, c, grid, tile, window,
                            scale).reshape(out.shape)
    torch.cuda.synchronize()
    assert sta.sta_ring.LAUNCHES == n0 + 1
    assert out.dtype == dtype and out.shape == ref.shape == (b, *grid, h * d)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(out.float(), direct.float(), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("ring_case", [True, False],
                         ids=["ring_gate", "gate_rejects"])
def test_sta_ring_dispatch_counts(dev, ring_case):
    """set_sta_ring(True): a geometry inside the gate launches sta_ring and
    not sta_direct; one outside it (gh = 2 < wh = 3) launches sta_direct;
    the image outputs agree with the ring switched off."""
    from hunyuanvideo_efficiency_tpu_torch.ops import sta

    grid, tile, window, lt, txt_valid = (RING_CASES[0] if ring_case
                                         else STA_CASES[1])
    assert ring_geometry_ok(grid, tile, window) == ring_case
    img, txt, tb, c = _sta_inputs(dev, torch.bfloat16, grid, 128, lt,
                                  txt_valid, seed=10)
    kw = dict(grid=grid, tile=tile, window=window, bound_mode="static",
              score_bound=c)
    off = sta.sta_joint_attention(*img, *txt, tb, **kw)
    n0 = (sta.sta_ring.LAUNCHES, sta.sta_direct.LAUNCHES)
    sta.set_sta_ring(True)
    try:
        on = sta.sta_joint_attention(*img, *txt, tb, **kw)
    finally:
        sta.set_sta_ring(False)
    torch.cuda.synchronize()
    assert (sta.sta_ring.LAUNCHES - n0[0], sta.sta_direct.LAUNCHES - n0[1]) \
        == ((1, 0) if ring_case else (0, 1))
    for x, y in zip(on, off):
        torch.testing.assert_close(x.float(), y.float(), atol=TOL, rtol=TOL)


# B10 beyond RING_CASES: (grid, tile, window, text keys, valid text keys of
# batch 1). A ragged grid with one text key, 3 valid of 129 (the text
# chunks past the last one not walked), every text key of batch 1 masked,
# a ragged grid of 64-token tiles (key chunks pair two boxes), an even
# window (the ring's own tile set: B4 rejects it).
RING_EDGE_CASES = [
    ((5, 17, 30), (4, 8, 8), (3, 3, 3), 1, 1),
    ((6, 24, 24), (4, 8, 8), (3, 3, 3), 129, 3),
    ((5, 17, 30), (4, 8, 8), (1, 3, 3), 64, 0),
    ((9, 10, 19), (2, 4, 8), (3, 3, 3), 256, 3),
    ((4, 12, 16), (2, 4, 8), (2, 2, 2), 64, 30),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", RING_EDGE_CASES)
def test_sta_ring_kernel_edges(dev, dtype, case):
    """B10 (csrc/sta_direct.cu, RING) against sta_ring_plain and, for odd
    windows, B4 on the row-major inputs; two runs equal bit for bit; one
    launch counted a call."""
    from hunyuanvideo_efficiency_tpu_torch.ops import sta

    grid, tile, window, lt, txt_valid = case
    d = 128
    (iq, ik, iv), (_, tk, tv), tb, c = _sta_inputs(dev, dtype, grid, d, lt,
                                                   txt_valid, seed=18)
    b, s, h, _ = iq.shape
    scale = d ** -0.5
    pg = sta._padded_grid(grid, tile)
    args = (iq.reshape(b, *grid, h * d),
            sta._permute_tokens_cols(ik, grid, tile, pg),
            sta._permute_tokens_cols(iv, grid, tile, pg),
            tk.reshape(b, lt, h * d), tv.reshape(b, lt, h * d),
            tb.reshape(b, lt), c, grid, tile, window, scale)
    n0 = sta.sta_ring.LAUNCHES
    out, again = sta.sta_ring(*args), sta.sta_ring(*args)
    ref = sta.sta_ring_plain(*args)
    torch.cuda.synchronize()
    assert sta.sta_ring.LAUNCHES == n0 + 2
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=TOL)
    if window[0] % 2:
        direct = sta.sta_direct(iq, ik, iv, tk, tv, tb, c, grid, tile,
                                window, scale).reshape(out.shape)
        torch.testing.assert_close(out.float(), direct.float(), atol=TOL,
                                   rtol=TOL)


# B7 beyond STA_CASES: T = 5 of 4-frame tiles, so the last frame row's
# second 128-row query box is pure padding (stored as zeros) and its key
# boxes of padding frames are skipped, with every text key of batch 1
# masked; a ragged grid of 64-token tiles; a 192-token tile (64-row boxes,
# three a tile); one text key.
PERMUTED_EDGE_CASES = [
    ((5, 17, 30), (4, 8, 8), (3, 3, 3), 64, 0),
    ((9, 10, 19), (2, 4, 8), (3, 3, 3), 256, 3),
    ((7, 16, 16), (3, 8, 8), (3, 3, 3), 129, 100),
    ((6, 16, 24), (4, 8, 8), (1, 3, 3), 1, 1),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", PERMUTED_EDGE_CASES)
def test_sta_permuted_running_edges(dev, dtype, d, case):
    """B7 (csrc/sta_permuted.cu) against sta_permuted_plain's running arm
    on the whole tile-major output (padding rows zero), with an image key
    bias that masks some keys; two runs equal bit for bit; one launch
    counted a call."""
    from hunyuanvideo_efficiency_tpu_torch.ops import sta

    grid, tile, window, lt, txt_valid = case
    (iq, ik, iv), (_, tk, tv), tb, _ = _sta_inputs(dev, dtype, grid, d, lt,
                                                   txt_valid, seed=19)
    ikb = torch.zeros(iq.shape[:2], device=dev)
    ikb[1, ::5] = -1e30
    ikb[0, 3::7] = -0.5
    _, qp, kcat, vcat, kb = sta.permuted_operands(
        iq, ik, iv, tk, tv, tb, grid, tile, window, ikb)
    args = (qp, kcat, vcat, kb, grid, tile, window, d ** -0.5)
    n0 = sta.sta_permuted_running.LAUNCHES
    out, again = (sta.sta_permuted_running(*args) for _ in range(2))
    ref = sta.sta_permuted_plain(*args)
    torch.cuda.synchronize()
    assert sta.sta_permuted_running.LAUNCHES == n0 + 2
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["static", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", PERMUTED_EDGE_CASES)
def test_sta_permuted_static_edges(dev, dtype, d, case, quant):
    """B6a/B6b and B6q (csrc/sta_permuted.cu, RUNNING=0 and QUANT=1)
    against sta_permuted_plain's static arm (qk_int8: every key tile
    quantized, text included) on the whole tile-major output (padding rows
    zero), with an image key bias that masks some keys and vcat a column
    view of a fused [B, S, 2, H, D] pair; two runs equal bit for bit; one
    launch counted a call."""
    from hunyuanvideo_efficiency_tpu_torch.ops import sta
    from hunyuanvideo_efficiency_tpu_torch.ops.flash_attention import (
        int8_bound_inflation)

    grid, tile, window, lt, txt_valid = case
    (iq, ik, iv), (_, tk, tv), tb, c = _sta_inputs(dev, dtype, grid, d, lt,
                                                   txt_valid, seed=25)
    if quant:
        c = c * int8_bound_inflation(d)
    ikb = torch.zeros(iq.shape[:2], device=dev)
    ikb[1, ::5] = -1e30
    ikb[0, 3::7] = -0.5
    _, qp, kcat, vcat, kb = sta.permuted_operands(
        iq, ik, iv, tk, tv, tb, grid, tile, window, ikb)
    pair = torch.zeros(*vcat.shape[:2], 2, *vcat.shape[2:], dtype=dtype,
                       device=dev)
    pair[:, :, 1] = vcat
    vcat = pair[:, :, 1]
    assert not vcat.is_contiguous()
    fn = sta.sta_permuted_static_int8 if quant else sta.sta_permuted_static
    args = (qp, kcat, vcat, kb, c, grid, tile, window, d ** -0.5)
    n0 = fn.LAUNCHES
    out, again = (fn(*args) for _ in range(2))
    ref = sta.sta_permuted_plain(qp, kcat, vcat, kb, grid, tile, window,
                                 d ** -0.5, c, qk_int8=quant)
    torch.cuda.synchronize()
    assert fn.LAUNCHES == n0 + 2
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("grid,tile", [((5, 17, 30), (4, 8, 8)),
                                       ((9, 10, 19), (2, 4, 8)),
                                       ((17, 34, 60), (4, 8, 8))])
def test_sta_permuted_codes_equal_tile_codes(dev, dtype, d, grid, tile):
    """B6q's pre-pass (sta_permuted_codes) against tile_codes bit for bit:
    the codes of qp and kcat in their tile-major rows (padding rows and the
    text blocks included) and the scales; kcat a strided view."""
    from hunyuanvideo_efficiency_tpu_torch.ops import sta

    (iq, ik, iv), (_, tk, tv), tb, _ = _sta_inputs(dev, dtype, grid, d, 256,
                                                   40, seed=26)
    _, qp, kcat, _, _ = sta.permuted_operands(iq, ik, iv, tk, tv, tb, grid,
                                              tile, (3, 3, 3))
    pair = torch.zeros(*kcat.shape[:2], 2, *kcat.shape[2:], dtype=dtype,
                       device=dev)
    pair[:, :, 0] = kcat
    kcat = pair[:, :, 0]
    block = tile[0] * tile[1] * tile[2]
    q8, k8, sq, sk = sta.sta_permuted_codes(qp, kcat, tile)
    torch.cuda.synchronize()
    for x, codes, scales in ((qp, q8, sq), (kcat, k8, sk)):
        want, want_sc = sta.tile_codes(x, block)
        assert codes.dtype == torch.int8
        assert torch.equal(codes.float(), want.reshape(codes.shape))
        assert torch.equal(scales, want_sc.permute(0, 2, 1))


@pytest.mark.parametrize("kernel", ["sta_permuted_static",
                                    "sta_permuted_static_int8",
                                    "sta_permuted_running"])
def test_sta_permuted_outside_the_gate_raises(dev, kernel):
    """On the card a geometry outside sta_permuted_gate raises, naming the
    wrapper, and launches nothing: tiles of 32 tokens, head_dim 32."""
    from hunyuanvideo_efficiency_tpu_torch.ops import sta

    fn = getattr(sta, kernel)
    for d, tile, match in ((64, (2, 4, 4), "32 tokens"),
                           (32, (2, 4, 8), "head_dim")):
        grid, window = (4, 8, 16), (3, 3, 3)
        (iq, ik, iv), (_, tk, tv), tb, c = _sta_inputs(
            dev, torch.bfloat16, grid, d, 64, 64)
        _, qp, kcat, vcat, kb = sta.permuted_operands(
            iq, ik, iv, tk, tv, tb, grid, tile, window)
        args = ((qp, kcat, vcat, kb) + (() if kernel.endswith("running")
                                        else (c,))
                + (grid, tile, window, d ** -0.5))
        n0 = fn.LAUNCHES
        with pytest.raises(ValueError, match=f"{kernel}: .*{match}"):
            fn(*args)
        assert fn.LAUNCHES == n0


@pytest.mark.parametrize("kernel", ["sta_ring", "sta_permuted_running"])
def test_sta_ring_and_running_at_the_540p_shape(dev, kernel):
    """B10 and B7 at the STA main path's shape, [2, 34680, 24, 128] bf16 on
    the 17x34x60 grid with 256 text keys (40 valid), against their plain
    versions (B10 also against B4 on the same inputs): max error relative
    to the output's scale 2e-2."""
    from hunyuanvideo_efficiency_tpu_torch.ops import sta

    grid, tile, window = (17, 34, 60), (4, 8, 8), (3, 3, 3)
    g = torch.Generator(dev).manual_seed(20)
    b, h, d, lt = 2, 24, 128, 256
    s = grid[0] * grid[1] * grid[2]

    def normed(n):
        x = torch.randn(b, n, h, d, generator=g, device=dev)
        return (x * torch.rsqrt(x.square().mean(-1, keepdim=True))).bfloat16()

    iq, ik, tk = normed(s), normed(s), normed(lt)
    iv, tv = (torch.randn(b, n, h, d, generator=g, device=dev).bfloat16()
              for n in (s, lt))
    tb = torch.zeros(b, 1, 1, lt, device=dev)
    tb[..., 40:] = -1e30
    scale = d ** -0.5
    c = torch.full((b, h), d ** 0.5, device=dev)   # |q.k| * scale <= sqrt(d)
    refs = []
    if kernel == "sta_ring":
        pg = sta._padded_grid(grid, tile)
        args = (iq.reshape(b, *grid, h * d),
                sta._permute_tokens_cols(ik, grid, tile, pg),
                sta._permute_tokens_cols(iv, grid, tile, pg),
                tk.reshape(b, lt, h * d), tv.reshape(b, lt, h * d),
                tb.reshape(b, lt), c, grid, tile, window, scale)
        out = sta.sta_ring(*args).reshape(b, s, h * d)
        refs.append(sta.sta_ring_plain(*args).reshape(b, s, h * d))
        refs.append(sta.sta_direct(iq, ik, iv, tk, tv, tb, c, grid, tile,
                                   window, scale))
    else:
        _, qp, kcat, vcat, kb = sta.permuted_operands(
            iq, ik, iv, tk, tv, tb, grid, tile, window)
        args = (qp, kcat, vcat, kb, grid, tile, window, scale)
        out = sta.sta_permuted_running(*args)
        refs.append(sta.sta_permuted_plain(*args))
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    for ref in refs:
        err = (out.float() - ref.float()).abs().max() / ref.float().abs().max()
        assert err < 2e-2


@pytest.mark.parametrize("kw", [dict(direct=False), dict(fused=False)])
def test_sta_direct_matches_permuted(dev, kw):
    """sta_joint_attention's direct arm (B4 + text merge through K1) against
    its permuted static arm (B6 + one K1 over kcat) on the same inputs."""
    from hunyuanvideo_efficiency_tpu_torch.ops.sta import sta_joint_attention

    grid, tile, window, lt, txt_valid = STA_CASES[2]
    img, txt, tb, c = _sta_inputs(dev, torch.bfloat16, grid, 128, lt,
                                  txt_valid, seed=4)
    common = dict(grid=grid, tile=tile, window=window, bound_mode="static",
                  score_bound=c)
    a = sta_joint_attention(*img, *txt, tb, **common)
    bb = sta_joint_attention(*img, *txt, tb, **common, **kw)
    torch.cuda.synchronize()
    for x, y in zip(a, bb):
        torch.testing.assert_close(x.float(), y.float(), atol=TOL, rtol=TOL)


# (rows, K, N, bias, activation): every schedule of plan_w8a8 on a
# 132-SM card (tests/test_torch_int8_linear.py checks which each takes)
W8A8_CASES = [
    (1, 384, 256, False, "silu"),       # short M, split-K
    (2, 512, 384, True, None),          # the modulation matvec class
    (63, 256, 256, True, "gelu"),
    (64, 256, 256, True, "relu"),       # the last short-M row count
    (65, 256, 256, False, None),        # the first above it: 64 x 128
    (77, 256, 256, False, None),        # ragged rows
    (129, 256, 128, True, "gelu"),
    (300, 512, 640, True, "gelu_tanh"),  # fc1 with the fused activation
    (512, 256, 9216, True, None),       # middle M: 128 x 128 tiles
    (6000, 256, 384, True, None),       # 128 x 256, ragged rows and N
    (8064, 256, 2304, False, "gelu_tanh"),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,k,n,bias,act", W8A8_CASES)
def test_w8a8_kernel_matches_plain(dev, dtype, m, k, n, bias, act):
    """B9 against its plain version: without an activation the two are the
    same arithmetic (exact s32, the same fp32 epilogue), so equal; with
    one, 1e-2 (transcendentals of another library)."""
    from hunyuanvideo_efficiency_tpu_torch.ops.int8_matmul import (
        w8a8_linear, w8a8_linear_plain)
    from hunyuanvideo_efficiency_tpu_torch.ops.quantization import (
        quantize_tensor_int8)

    g = torch.Generator(dev).manual_seed(5)
    x = (torch.randn(m, k, generator=g, device=dev) * 3).to(dtype)
    w8, so = quantize_tensor_int8(torch.randn(n, k, generator=g, device=dev))
    b = torch.randn(n, generator=g, device=dev).to(dtype) if bias else None
    n0 = w8a8_linear.LAUNCHES
    out = w8a8_linear(x, w8, so, b, act)
    ref = w8a8_linear_plain(x, w8, so, b, act)
    torch.cuda.synchronize()
    assert w8a8_linear.LAUNCHES == n0 + 1
    assert out.dtype == dtype and out.shape == (m, n)
    if act is None:
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("rows", [2, 90])
@pytest.mark.parametrize("shape,out_sl,in_sl", [
    ((768, 512), slice(128, 512), slice(0, 256)),    # linear1's columns
    ((768, 512), slice(0, 768), slice(256, 512)),
    ((256, 1280), slice(0, 256), slice(256, 1280)),  # linear2's MLP rows
])
def test_w8a8_kernel_strided_slices(dev, rows, shape, out_sl, in_sl):
    """Column and K slices of one weight (the single block's linear1 /
    linear2 slices) reach the kernel as strided views, [B, L, K] inputs;
    the short (split-K) and the token-sized schedules."""
    from hunyuanvideo_efficiency_tpu_torch.ops.int8_matmul import (
        w8a8_linear, w8a8_linear_plain)
    from hunyuanvideo_efficiency_tpu_torch.ops.quantization import (
        quantize_tensor_int8)

    g = torch.Generator(dev).manual_seed(6)
    w8, so = quantize_tensor_int8(torch.randn(*shape, generator=g,
                                              device=dev))
    wv = w8[out_sl, in_sl]
    assert wv.stride(0) == shape[1]
    x = torch.randn(2, rows // 2, wv.shape[1], generator=g,
                    device=dev).bfloat16()
    out = w8a8_linear(x, wv, so[out_sl])
    ref = w8a8_linear_plain(x, wv, so[out_sl])
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def test_w8a8_split_k_repeatable(dev):
    """The double block's modulation matvec [2, 3072] -> 18432 takes the
    split-K schedule; two runs equal each other and the plain version bit
    for bit (s32 partial sums, added as integers)."""
    from hunyuanvideo_efficiency_tpu_torch.ops.int8_matmul import (
        _sm_count, plan_w8a8, w8a8_linear, w8a8_linear_plain)
    from hunyuanvideo_efficiency_tpu_torch.ops.quantization import (
        quantize_tensor_int8)

    g = torch.Generator(dev).manual_seed(9)
    w8, so = quantize_tensor_int8(torch.randn(18432, 3072, generator=g,
                                              device=dev))
    x = torch.randn(2, 3072, generator=g, device=dev).bfloat16()
    assert plan_w8a8(2, 18432, 3072, _sm_count(x.device)).split > 1
    first = w8a8_linear(x, w8, so)
    second = w8a8_linear(x, w8, so)
    ref = w8a8_linear_plain(x, w8, so)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, ref)


def test_w8a8_prepass_equals_plain(dev):
    """The pre-pass alone: codes and scales equal quantize_rows bit for
    bit (a division and round-to-nearest-even, as the plain version), fp16
    rows with a column-view stride."""
    from hunyuanvideo_efficiency_tpu_torch.ops.int8_matmul import (
        quantize_rows, w8a8_prepass)

    g = torch.Generator(dev).manual_seed(10)
    x = (torch.randn(300, 2 * 1024, generator=g, device=dev) * 5).half()
    x[7, 3] = 60000.0
    x = x[:, 1024:]
    xq, sx = w8a8_prepass(x)
    rq, rs = quantize_rows(x)
    torch.cuda.synchronize()
    assert torch.equal(xq, rq) and torch.equal(sx, rs[:, 0])


# B9's two arms at the world-4 slices of Llama-3-8B's tensor-parallel
# tower: K 1024 (o_proj) and 3584 (down_proj), N 256 (k/v) and 1024 (q),
# two rows (the split-K schedule) and a CFG pair of 351-token prompts
W8A8_TP_CASES = [(m, k, n) for m in (2, 702) for k in (1024, 3584)
                 for n in (256, 1024)]


def _w8a8_tp_operands(dev, m, k, n, seed):
    """x [m, k] bf16, an int8 weight [n, k] with its scale_out, and row
    scales of a wider row (the amax of x and of a second slice of 3k
    columns, as the all-reduced amax over four ranks)."""
    from hunyuanvideo_efficiency_tpu_torch.ops.int8_matmul import row_scales
    from hunyuanvideo_efficiency_tpu_torch.ops.quantization import (
        quantize_tensor_int8)

    g = torch.Generator(dev).manual_seed(seed)
    x = (torch.randn(m, k, generator=g, device=dev) * 3).bfloat16()
    rest = (torch.randn(m, 3 * k, generator=g, device=dev) * 3).bfloat16()
    sx = row_scales(torch.maximum(x.abs().amax(-1), rest.abs().amax(-1)))
    w8, so = quantize_tensor_int8(torch.randn(n, k, generator=g, device=dev))
    return x, w8, so, sx


@pytest.mark.parametrize("m,k,n", W8A8_TP_CASES)
def test_w8a8_given_scale_equals_plain(dev, m, k, n):
    """The given-scale arm: the pre-pass quantizes with the caller's row
    scales (no amax of its own), equal to the plain version bit for bit."""
    from hunyuanvideo_efficiency_tpu_torch.ops.int8_matmul import (
        w8a8_linear, w8a8_linear_plain)

    x, w8, so, sx = _w8a8_tp_operands(dev, m, k, n, 11)
    out = w8a8_linear(x, w8, so, row_scale=sx)
    ref = w8a8_linear_plain(x, w8, so, row_scale=sx)
    own = w8a8_linear(x, w8, so)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert not torch.equal(out, own)     # the given scale was used


@pytest.mark.parametrize("m,k,n", W8A8_TP_CASES)
def test_w8a8_s32_equals_plain(dev, m, k, n):
    """The s32 arm (epilogue off) equals the plain int32 sums exactly,
    under the split-K schedule (m = 2) too, with its own scales and with
    given ones."""
    from hunyuanvideo_efficiency_tpu_torch.ops.int8_matmul import (
        _sm_count, plan_w8a8, w8a8_linear, w8a8_linear_plain)

    x, w8, so, sx = _w8a8_tp_operands(dev, m, k, n, 12)
    assert (plan_w8a8(m, n, k, _sm_count(x.device)).split > 1) == (m == 2)
    for scale in (None, sx):
        out = w8a8_linear(x, w8, so, row_scale=scale, s32=True)
        ref = w8a8_linear_plain(x, w8, so, row_scale=scale, s32=True)
        torch.cuda.synchronize()
        assert out.dtype == torch.int32 and out.shape == (m, n)
        assert torch.equal(out, ref)


@pytest.mark.parametrize("m", [2, 702])
@pytest.mark.parametrize("k,n", [(1024, 4096), (3584, 4096)])
def test_w8a8_row_parallel_equals_one_call(dev, m, k, n):
    """A row-parallel linear over four K slices (o_proj, down_proj of
    the world-4 tower): each slice quantized with the whole row's scale,
    its s32 sums added as integers, dequantized as the epilogue does,
    equals one B9 call over the whole K bit for bit."""
    from hunyuanvideo_efficiency_tpu_torch.ops.int8_matmul import (
        row_scales, w8a8_linear)
    from hunyuanvideo_efficiency_tpu_torch.ops.quantization import (
        quantize_tensor_int8)

    g = torch.Generator(dev).manual_seed(13)
    x = (torch.randn(m, 4 * k, generator=g, device=dev) * 3).bfloat16()
    w8, so = quantize_tensor_int8(torch.randn(n, 4 * k, generator=g,
                                              device=dev))
    sx = row_scales(torch.stack([x[:, r * k:(r + 1) * k].abs().amax(-1)
                                 for r in range(4)]).amax(0))
    acc = sum(w8a8_linear(x[:, r * k:(r + 1) * k], w8[:, r * k:(r + 1) * k],
                          so, row_scale=sx, s32=True) for r in range(4))
    out = (acc.float() * sx[:, None] * so).bfloat16()
    ref = w8a8_linear(x, w8, so)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [200, 1280])
@pytest.mark.parametrize("running", [False, True])
def test_flash_int8_kernels_match_plain(dev, dtype, d, s, running):
    """B8a/B8b against flash_int8_plain with the groups the wrapper picks
    (S = 1280: query groups of 256, key groups of 640); batch 1 masks a
    whole 64-key chunk and the tail."""
    from hunyuanvideo_efficiency_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(dev).manual_seed(7)
    b, h = 2, 3
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
               for _ in range(3))
    q = (torch.nn.functional.normalize(q.float(), dim=-1) * 4).to(dtype)
    k = (torch.nn.functional.normalize(k.float(), dim=-1) * 4).to(dtype)
    kb = torch.zeros(b, s, device=dev)
    kb[1, 64:128] = -1e30
    kb[1, s - 13:] = -1e30
    scale = d ** -0.5
    c = torch.full((b, h), 16.0 * scale * fa.int8_bound_inflation(d),
                   device=dev)
    qg = fa.pick_block(1024, s)
    kg = fa.int8_key_group(fa.pick_block(2048, s), not running)
    counter = fa.flash_int8_running if running else fa.flash_int8_static
    n0 = counter.LAUNCHES
    if running:
        out = fa.flash_int8_running(q, k, v, kb, scale, qg, kg)
    else:
        out = fa.flash_int8_static(q, k, v, kb, c, scale, qg, kg)
    ref = fa.flash_int8_plain(q, k, v, kb, c, scale, running, qg, kg)
    torch.cuda.synchronize()
    assert counter.LAUNCHES == n0 + 1
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("running", [False, True])
def test_flash_int8_state_matches_plain(dev, running):
    """B8a/B8b with return_state (what a ring hop calls): the output and
    the state (m, l) against flash_int8_plain's, batch 1 with a masked
    tail."""
    from hunyuanvideo_efficiency_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(dev).manual_seed(8)
    b, h, s, d = 2, 3, 1280, 128
    q, k = (torch.nn.functional.normalize(torch.randn(
        b, s, h, d, generator=g, device=dev), dim=-1).mul(4).bfloat16()
        for _ in range(2))
    v = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
    kb = torch.zeros(b, s, device=dev)
    kb[1, s - 13:] = -1e30
    scale = d ** -0.5
    c = torch.full((b, h), 16.0 * scale * fa.int8_bound_inflation(d),
                   device=dev)
    qg, kg = 256, 640
    if running:
        got = fa.flash_int8_running(q, k, v, kb, scale, qg, kg, True)
    else:
        got = fa.flash_int8_static(q, k, v, kb, c, scale, qg, kg, True)
    want = fa.flash_int8_plain(q, k, v, kb, c, scale, running, qg, kg, True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=TOL,
                               rtol=TOL)
    torch.testing.assert_close(got[1], want[1], atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(got[2], want[2], atol=1e-2, rtol=1e-2)


# (query rows, keys, query group, key group or None for the wrapper's pick,
# head_dim, v a column view of a fused [B, S, 3*H*D] projection)
INT8_CASES = [
    (4288, 4288, None, None, 128, False),  # the main path's length, groups
    (4288, 4288, None, None, 128, True),
    (4288, 4288, 64, 64, 128, False),      # two groups a 128-row/-key tile
    (1000, 1000, 64, 64, 64, True),
    (4288, 4288, 64, 64, 64, False),
    (200, 200, 64, 128, 128, True),        # keys under two tiles, ragged
    # more work items than SMs, fewer key tiles than ring slots: the
    # persistent CTAs' ring runs on across items
    (4288, 200, 1024, 128, 128, False),
    (4288, 100, 64, 64, 64, True),
]


def _int8_inputs(dev, dtype, s, d, fused_v, seed=8, sk=None):
    g = torch.Generator(dev).manual_seed(seed)
    b, h = 2, 3
    sk = s if sk is None else sk
    q = torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(b, sk, h, d, generator=g, device=dev).to(dtype)
            for _ in range(2))
    q = (torch.nn.functional.normalize(q.float(), dim=-1) * 4).to(dtype)
    k = (torch.nn.functional.normalize(k.float(), dim=-1) * 4).to(dtype)
    if fused_v:
        fused = torch.zeros(b, sk, 3, h, d, dtype=dtype, device=dev)
        fused[:, :, 2] = v
        v = fused[:, :, 2]
        assert not v.is_contiguous()
    kb = torch.zeros(b, sk, device=dev)
    kb[1, 64:min(128, sk - 13)] = -1e30
    kb[1, sk - 13:] = -1e30
    return q, k, v, kb


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s,qg,kg,d", [(4288, 1024, 512, 128),
                                       (4288, 1024, 1024, 64),
                                       (300, 64, 64, 128), (200, 256, 128,
                                                            64)])
def test_int8_prepass_equals_plain(dev, dtype, s, qg, kg, d):
    """The quantization pre-pass kernel against quantize_groups_plain: the
    same int8 codes and the same scales, bit for bit; q a column view of a
    fused projection."""
    from hunyuanvideo_efficiency_tpu_torch.ops import flash_attention as fa

    q, k, _, _ = _int8_inputs(dev, dtype, s, d, False)
    fused = torch.zeros(q.shape[0], s, 3, *q.shape[2:], dtype=dtype,
                        device=dev)
    fused[:, :, 0] = q
    q = fused[:, :, 0]
    (q8, sq), (k8, sk) = fa.quantize_groups(q, k, qg, kg)
    torch.cuda.synchronize()
    for got, want in (((q8, sq), fa.quantize_groups_plain(q, qg)),
                      ((k8, sk), fa.quantize_groups_plain(k, kg))):
        assert got[0].dtype == torch.int8 and got[0].shape == want[0].shape
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s,sk,qg,kg,d,fused_v", INT8_CASES)
@pytest.mark.parametrize("running", [False, True])
def test_flash_int8_kernels_at_length(dev, dtype, s, sk, qg, kg, d, fused_v,
                                      running):
    """B8a/B8b at the main path's 4,288 tokens with the wrapper's groups and
    with groups of 64 passed directly, v as a column view, and queries over
    fewer keys, against flash_int8_plain; a second run equals the first bit
    for bit."""
    from hunyuanvideo_efficiency_tpu_torch.ops import flash_attention as fa

    q, k, v, kb = _int8_inputs(dev, dtype, s, d, fused_v, sk=sk)
    scale = d ** -0.5
    c = torch.full((2, 3), 16.0 * scale * fa.int8_bound_inflation(d),
                   device=dev)
    qg = qg or fa.pick_block(1024, s)
    kg = kg or fa.int8_key_group(fa.pick_block(2048, sk), not running)
    counter = fa.flash_int8_running if running else fa.flash_int8_static

    def run():
        if running:
            return fa.flash_int8_running(q, k, v, kb, scale, qg, kg)
        return fa.flash_int8_static(q, k, v, kb, c, scale, qg, kg)

    n0 = counter.LAUNCHES
    out, again = run(), run()
    ref = fa.flash_int8_plain(q, k, v, kb, c, scale, running, qg, kg)
    torch.cuda.synchronize()
    assert counter.LAUNCHES == n0 + 2
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", STA_CASES)
def test_sta_int8_kernels_match_plain(dev, dtype, d, case):
    """The quant arms of B4 (text keys in the input type) and B6 (text
    blocks quantized like key tiles) against their plain versions."""
    from hunyuanvideo_efficiency_tpu_torch.ops import sta
    from hunyuanvideo_efficiency_tpu_torch.ops.flash_attention import (
        int8_bound_inflation)

    grid, tile, window, lt, txt_valid = case
    (iq, ik, iv), (_, tk, tv), tb, c = _sta_inputs(dev, dtype, grid, d, lt,
                                                   txt_valid, seed=8)
    c = c * int8_bound_inflation(d)
    scale = d ** -0.5
    plan, qp, kcat, vcat, kb = sta.permuted_operands(
        iq, ik, iv, tk, tv, tb, grid, tile, window)
    n0 = (sta.sta_direct_int8.LAUNCHES, sta.sta_permuted_static_int8.LAUNCHES)
    direct = sta.sta_direct_int8(iq, ik, iv, tk, tv, tb, c, grid, tile,
                                 window, scale)
    permuted = sta.sta_permuted_static_int8(qp, kcat, vcat, kb, c, grid,
                                            tile, window, scale)
    ref_d = sta.sta_attention_plain(iq, ik, iv, tk, tv, tb, grid, tile,
                                    window, scale, c, qk_int8=True)
    ref_p = sta.sta_permuted_plain(qp, kcat, vcat, kb, grid, tile, window,
                                   scale, c, qk_int8=True)
    torch.cuda.synchronize()
    assert (sta.sta_direct_int8.LAUNCHES,
            sta.sta_permuted_static_int8.LAUNCHES) == (n0[0] + 1, n0[1] + 1)
    for out, ref in ((direct, ref_d), (permuted, ref_p)):
        assert out.dtype == dtype and out.shape == ref.shape
        torch.testing.assert_close(out.float(), ref.float(), atol=TOL,
                                   rtol=TOL)


def _backward_inputs(dev, dtype, sq, sk, d, masked, seed=21):
    """q/k of unit norm times 4, v and dO ~ N(0, 1), a key bias masking the
    last `masked` keys of batch 1, as strided views of fused projections
    (q/k/v as columns of one [B, S, 3, H, D] tensor when sq == sk)."""
    g = torch.Generator(dev).manual_seed(seed)
    b, h = 2, 3

    def unit(x):
        return (torch.nn.functional.normalize(x.float(), dim=-1) * 4)

    if sq == sk:
        fused = torch.randn(b, sq, 3, h, d, generator=g, device=dev)
        fused[:, :, 0], fused[:, :, 1] = unit(fused[:, :, 0]), unit(
            fused[:, :, 1])
        fused = fused.to(dtype)
        q, k, v = fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]
        assert not q.is_contiguous()
    else:
        q = unit(torch.randn(b, sq, h, d, generator=g, device=dev)).to(dtype)
        k = unit(torch.randn(b, sk, h, d, generator=g, device=dev)).to(dtype)
        v = torch.randn(b, sk, h, d, generator=g, device=dev).to(dtype)
    do = torch.randn(b, sq, h * d, generator=g, device=dev).to(dtype)
    kb = torch.zeros(b, sk, device=dev)
    if masked:
        kb[1, sk - masked:] = -1e30
    return q, k, v, kb, do


# (query rows, keys, masked keys of the last batch entry): the kernels own
# 128 rows a block and walk tiles of 64; one past and one short of both, and
# keys under one tile
BACKWARD_CASES = [(200, 200, 13), (77, 333, 0), (333, 77, 20), (1000, 1000, 5),
                  (129, 129, 7), (63, 191, 0), (127, 65, 3), (191, 63, 0),
                  (300, 40, 9)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("sq,sk,masked", BACKWARD_CASES)
def test_flash_backward_kernels_match_plain(dev, dtype, d, sq, sk, masked):
    """B5f, B5q and B5kv on ragged query and key lengths, strided q/k/v
    views and masked keys, against their plain versions on the same lse
    and delta; masked keys get exactly zero dK and dV; two runs agree bit
    for bit; each wrapper counts one launch per call."""
    from hunyuanvideo_efficiency_tpu_torch.ops import flash_backward as fb

    q, k, v, kb, do = _backward_inputs(dev, dtype, sq, sk, d, masked)
    scale = d ** -0.5
    n0 = (fb.flash_fwd_lse.LAUNCHES, fb.flash_bwd_dq.LAUNCHES,
          fb.flash_bwd_dkv.LAUNCHES)
    out, lse = fb.flash_fwd_lse(q, k, v, kb, scale)
    ref_out, ref_lse = fb.flash_fwd_lse_plain(q, k, v, kb, scale)
    assert out.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref_out.float(), atol=TOL,
                               rtol=TOL)
    torch.testing.assert_close(lse, ref_lse, atol=2e-3, rtol=1e-4)
    delta = fb.row_delta(do, ref_out, q.shape[2])
    args = (q, k, v, kb, do, ref_lse, delta, scale)
    dq = fb.flash_bwd_dq(*args)
    dk, dv = fb.flash_bwd_dkv(*args)
    again = (fb.flash_bwd_dq(*args), *fb.flash_bwd_dkv(*args))
    ref = (fb.flash_bwd_dq_plain(*args), *fb.flash_bwd_dkv_plain(*args))
    torch.cuda.synchronize()
    assert (fb.flash_fwd_lse.LAUNCHES, fb.flash_bwd_dq.LAUNCHES,
            fb.flash_bwd_dkv.LAUNCHES) == (n0[0] + 1, n0[1] + 2, n0[2] + 2)
    for name, got, rerun, want in zip(("dq", "dk", "dv"), (dq, dk, dv), again,
                                      ref):
        assert got.dtype == dtype and got.shape == want.shape, name
        assert torch.isfinite(got.float()).all(), name
        assert torch.equal(got, rerun), name
        scale_ = want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=2 * TOL * scale_, rtol=TOL, msg=name)
    if masked:
        assert torch.count_nonzero(dk[1, sk - masked:]) == 0
        assert torch.count_nonzero(dv[1, sk - masked:]) == 0
        assert torch.count_nonzero(dv[1, :sk - masked]) > 0


def test_flash_backward_at_the_train_shape(dev):
    """B5q and B5kv at the train step's [1, 4288, 24, 128] bf16, v a column
    view of a fused [1, S, 3*H*D] projection, 216 masked text keys: against
    their plain versions at max relative error 2e-2 (bf16 outputs), two runs
    equal bit for bit, masked keys' dK and dV exactly zero."""
    from hunyuanvideo_efficiency_tpu_torch.ops import flash_backward as fb

    g = torch.Generator(dev).manual_seed(4)
    b, s, h, d = 1, 4288, 24, 128
    fused = torch.randn(b, s, 3, h, d, generator=g, device=dev)
    fused[:, :, :2] = torch.nn.functional.normalize(fused[:, :, :2],
                                                    dim=-1) * 4
    fused = fused.bfloat16()
    q, k = fused[:, :, 0].contiguous(), fused[:, :, 1].contiguous()
    v = fused[:, :, 2]
    assert not v.is_contiguous()
    do = torch.randn(b, s, h * d, generator=g, device=dev).bfloat16()
    kb = torch.zeros(b, s, device=dev)
    kb[:, -216:] = -1e30
    scale = d ** -0.5
    out, lse = fb.flash_fwd_lse_plain(q, k, v, kb, scale)
    delta = fb.row_delta(do, out, h)
    args = (q, k, v, kb, do, lse, delta, scale)
    got = (fb.flash_bwd_dq(*args), *fb.flash_bwd_dkv(*args))
    again = (fb.flash_bwd_dq(*args), *fb.flash_bwd_dkv(*args))
    want = (fb.flash_bwd_dq_plain(*args), *fb.flash_bwd_dkv_plain(*args))
    torch.cuda.synchronize()
    for name, x, x2, ref in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(x, x2), name
        err = ((x.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        assert err <= 2e-2, (name, err)
    assert torch.count_nonzero(got[1][:, -216:]) == 0
    assert torch.count_nonzero(got[2][:, -216:]) == 0
    assert torch.count_nonzero(got[2][:, :-216]) > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_vjp_on_the_card(dev, dtype):
    """flash_attention_vjp through autograd on the card (the backward runs
    on autograd's thread): gradients against autograd through plain
    attention in fp32, an expanded dO, and the LSE-free kernel when no
    gradient is wanted."""
    from hunyuanvideo_efficiency_tpu_torch.ops import flash_backward as fb
    from hunyuanvideo_efficiency_tpu_torch.ops.attention import sdpa_attention

    q, k, v, kb, _ = _backward_inputs(dev, dtype, 300, 300, 128, 17)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    n0 = (flash_static.LAUNCHES + flash_running.LAUNCHES,
          fb.flash_fwd_lse.LAUNCHES, fb.flash_bwd_dq.LAUNCHES,
          fb.flash_bwd_dkv.LAUNCHES)
    with torch.no_grad():
        fb.flash_attention_vjp(*leaves, kb)
    assert flash_static.LAUNCHES + flash_running.LAUNCHES == n0[0] + 1
    out = fb.flash_attention_vjp(*leaves, kb)
    out.sum().backward()          # dO is an expanded scalar
    torch.cuda.synchronize()
    assert (fb.flash_fwd_lse.LAUNCHES, fb.flash_bwd_dq.LAUNCHES,
            fb.flash_bwd_dkv.LAUNCHES) == (n0[1] + 1, n0[2] + 1, n0[3] + 1)
    ref_leaves = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
    sdpa_attention(*ref_leaves, bias=kb[:, None, None, :]).sum().backward()
    for got, want in zip(leaves, ref_leaves):
        assert got.grad.dtype == dtype
        scale_ = want.grad.abs().max().item()
        torch.testing.assert_close(got.grad.float(), want.grad,
                                   atol=3 * TOL * scale_, rtol=3 * TOL)


# (batch, tokens, heads, head_dim, table rows or None for freqs=None, q/k
# as column views of a fused [B, S, 3*H*D] projection, a norm weight)
QK_ROPE_CASES = [
    (2, 1000, 3, 128, 1000, True, True),
    (2, 1000, 3, 64, 1000, True, True),
    (2, 77, 5, 128, 77, False, True),        # ragged S, contiguous q/k
    (1, 333, 4, 128, 200, True, True),       # 133 norm-only rows
    (2, 300, 3, 64, 0, True, True),          # a 0-row table
    (2, 300, 3, 128, None, False, True),     # freqs=None
    (2, 300, 3, 64, 300, True, False),       # weight=None
    (2, 34936, 24, 128, 34936, True, True),  # the 540p single block
]


def _qk_rope_inputs(dev, dtype, b, s, h, d, rows, fused, weighted, seed=21):
    """q, k (column views of one projection, or contiguous), weights near
    1 and the DiT's tables: rows of the 3-axis table over a grid of 8x8
    frames, then identity rows up to S (the joint table's text rows)."""
    from hunyuanvideo_efficiency_tpu_torch.ops.rope import (
        get_nd_rotary_pos_embed)

    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(b, s, 3 * h * d, generator=g, device=dev) * 2 + 0.5
    x = x.to(dtype)
    q, k = (x[..., i * h * d:(i + 1) * h * d].unflatten(-1, (h, d))
            for i in range(2))
    if not fused:
        q, k = q.contiguous(), k.contiguous()
    w = [(1 + 0.3 * torch.randn(d, generator=g, device=dev)).to(dtype)
         if weighted else None for _ in range(2)]
    freqs = None
    if rows is not None:
        dims = (16, 56, 56) if d == 128 else (8, 28, 28)
        img = min(rows, 34680)
        sizes = (17, 34, 60) if img == 34680 else (-(-img // 64), 8, 8)
        cos, sin = get_nd_rotary_pos_embed(dims, sizes, device=dev)
        cos, sin = cos[:img], sin[:img]
        if rows > img:   # identity rows (cos 1, sin 0)
            cos = torch.cat([cos, cos.new_ones(rows - img, d)])
            sin = torch.cat([sin, sin.new_zeros(rows - img, d)])
        freqs = (cos, sin)
    return q, k, w, freqs


def _ulp_gap(out, ref):
    """|out - ref| over one ulp of the output type at the magnitude of
    each interleaved pair of ref (the rotation mixes a pair)."""
    mant = 7 if ref.dtype == torch.bfloat16 else 10
    tiny = torch.finfo(ref.dtype).tiny
    pair = ref.float().abs().unflatten(-1, (-1, 2)).amax(-1, keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(pair.clamp_min(tiny))) - mant)
    gap = (out.float() - ref.float()).abs().unflatten(-1, (-1, 2)) / ulp
    return gap.flatten(-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,s,h,d,rows,fused,weighted", QK_ROPE_CASES)
def test_qk_norm_rope_kernel_matches_plain(dev, dtype, b, s, h, d, rows,
                                           fused, weighted):
    """The QK-RMSNorm + RoPE kernel against qk_norm_rope_plain: within one
    ulp of the output type, at least 99.9% of the values bit for bit (the
    fp32 sum of squares runs in another order), one launch a call,
    contiguous outputs of the input's type."""
    from hunyuanvideo_efficiency_tpu_torch.ops.rope import (
        qk_norm_rope, qk_norm_rope_plain)

    q, k, w, freqs = _qk_rope_inputs(dev, dtype, b, s, h, d, rows, fused,
                                     weighted)
    assert q.is_contiguous() != fused
    n0 = qk_norm_rope.LAUNCHES
    out = qk_norm_rope(q, k, *w, freqs)
    torch.cuda.synchronize()
    assert qk_norm_rope.LAUNCHES == n0 + 1
    ref = qk_norm_rope_plain(q, k, *w, freqs)
    for o, r in zip(out, ref):
        assert o.shape == (b, s, h, d) and o.dtype == dtype
        assert o.is_contiguous() and torch.isfinite(o).all()
        gap = _ulp_gap(o, r)
        assert gap.max().item() <= 1.0, gap.max().item()
        same = (o == r).float().mean().item()
        assert same >= 0.999, same
    if rows is not None and 0 < rows < s:   # norm-only rows
        from hunyuanvideo_efficiency_tpu_torch.ops.norms import rms_norm

        tail = rms_norm(q[:, rows:], w[0])
        assert (_ulp_gap(out[0][:, rows:], tail).max() <= 1.0)


@pytest.mark.parametrize("dtype,d,wdtype", [
    (torch.float32, 128, None), (torch.bfloat16, 32, None),
    (torch.bfloat16, 128, torch.float32)])
def test_qk_norm_rope_outside_the_gate_raises(dev, dtype, d, wdtype):
    """fp32 values, head_dim 32 or a weight of another type: the wrapper
    raises on the card (no launch); plain=True runs the plain version."""
    from hunyuanvideo_efficiency_tpu_torch.ops.rope import (
        qk_norm_rope, qk_norm_rope_plain)

    q, k = (torch.randn(2, 50, 3, d, device=dev).to(dtype) for _ in range(2))
    w = torch.ones(d, device=dev, dtype=wdtype) if wdtype else None
    n0 = qk_norm_rope.LAUNCHES
    with pytest.raises(ValueError, match="does not take"):
        qk_norm_rope(q, k, w, w, None)
    assert qk_norm_rope.LAUNCHES == n0
    out = qk_norm_rope(q, k, w, w, None, plain=True)
    for o, r in zip(out, qk_norm_rope_plain(q, k, w, w, None)):
        assert torch.equal(o, r)


@pytest.mark.parametrize("mode,launches", [("flash", 2 * 2 + 2),
                                           ("sta", 2 * 2 + 2 * 2)])
def test_dit_forward_with_the_qk_rope_kernel(dev, mode, launches):
    """A 2+2-block DiT at head_dim 128 on the card, bf16, random QK-norm
    weights: the forward against plain=True (the plain QK-norm + RoPE, and
    under STA the plain STA image queries). Launches a forward: dense, one
    for the double block's image pair, one for its text pair, one for the
    single block's joint [img | txt] pair; STA splits the single block's
    pair too."""
    import dataclasses

    from hunyuanvideo_efficiency_tpu_torch.models import dit as dit_mod
    from hunyuanvideo_efficiency_tpu_torch.models.dit_config import DiTConfig
    from hunyuanvideo_efficiency_tpu_torch.ops.rope import (
        get_nd_rotary_pos_embed, qk_norm_rope)
    from hunyuanvideo_efficiency_tpu_torch.utils.seeded import (
        randomize_modulation)

    cfg = dataclasses.replace(
        DiTConfig(), hidden_size=256, heads_num=2, mm_double_blocks_depth=2,
        mm_single_blocks_depth=2, text_states_dim=64, text_states_dim_2=32,
        attn_mode=mode)
    g = torch.Generator(dev).manual_seed(23)
    model = dit_mod.build_dit(cfg, dev, torch.bfloat16, g)
    randomize_modulation(model, 24)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, dit_mod.RMSNorm):
                mod.weight.copy_(1 + 0.3 * torch.randn(
                    mod.weight.shape, generator=g, device=dev))
    grid = (8, 16, 16)
    x = torch.randn(2, 16, grid[0], 2 * grid[1], 2 * grid[2], generator=g,
                    device=dev)
    t = torch.tensor([900.0, 900.0], device=dev)
    txt = torch.randn(2, 64, 64, generator=g, device=dev)
    mask = torch.ones(2, 64, dtype=torch.long, device=dev)
    mask[:, 20:] = 0
    txt2 = torch.randn(2, 32, generator=g, device=dev)
    cos, sin = get_nd_rotary_pos_embed(cfg.rope_dim_list, grid,
                                       theta=cfg.rope_theta, device=dev)
    with torch.no_grad():
        n0 = qk_norm_rope.LAUNCHES
        out = model(x, t, txt, mask, txt2, cos, sin).float()
        torch.cuda.synchronize()
        assert qk_norm_rope.LAUNCHES == n0 + launches
        ref = model(x, t, txt, mask, txt2, cos, sin, plain=True).float()
        assert qk_norm_rope.LAUNCHES == n0 + launches
    assert torch.isfinite(out).all()
    rel = ((out - ref).norm() / ref.norm()).item()
    assert rel < (1e-2 if mode == "flash" else 5e-2), rel
