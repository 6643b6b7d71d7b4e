"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked `cuda`: without a CUDA device they skip (the decision is
made inside the fixture). Run them on a GPU host with
`python -m pytest tests/test_torch_cuda_kernels.py -q`.

Tolerances: bf16/fp16 outputs of O(1) values, one rounding of the output
plus fp32 sums in another order: 1e-2 absolute.
"""
import pytest
import torch

from hunyuanvideo_efficiency_tpu_torch.ops.conv3d_cuda import (
    conv3d_stride1, conv3d_stride1_plain)
from hunyuanvideo_efficiency_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_plain, flash_running, flash_static,
    merge_flash_states)

pytestmark = pytest.mark.cuda
TOL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("s,d", [(200, 128), (77, 64), (1000, 128)])
@pytest.mark.parametrize("running", [False, True])
def test_flash_kernel_matches_plain(dev, dtype, s, d, running):
    g = torch.Generator(dev).manual_seed(0)
    b, h = 2, 3
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
               for _ in range(3))
    q = torch.nn.functional.normalize(q.float(), dim=-1).to(dtype) * 4
    k = torch.nn.functional.normalize(k.float(), dim=-1).to(dtype) * 4
    kb = torch.zeros(b, s, device=dev)
    kb[1, s - 13:] = -1e30
    c = torch.full((b, h), 16.0 * d ** -0.5 * 1.02, device=dev)
    scale = d ** -0.5
    n0 = (flash_static.LAUNCHES, flash_running.LAUNCHES)
    if running:
        out = flash_running(q, k, v, kb, scale, return_state=True)
    else:
        out = flash_static(q, k, v, kb, c, scale, return_state=True)
    ref = flash_attention_plain(q, k, v, kb, c, scale, running, True)
    torch.cuda.synchronize()
    assert (flash_static.LAUNCHES, flash_running.LAUNCHES) == \
        ((n0[0], n0[1] + 1) if running else (n0[0] + 1, n0[1]))
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        torch.testing.assert_close(o.float(), r.float(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("bound_mode", ["static", "running"])
def test_flash_kernel_split_keys_merge(dev, bound_mode):
    """Queries against two key sets of other lengths, no key bias, with
    state; the merged states equal attention over all keys."""
    g = torch.Generator(dev).manual_seed(2)
    q, k, v = (torch.randn(1, n, 4, 128, generator=g, device=dev)
               .bfloat16() for n in (100, 333, 333))
    halves = [flash_attention(q, k[:, sl], v[:, sl], bound_mode=bound_mode,
                              return_state=True)
              for sl in (slice(0, 77), slice(77, None))]
    for (o, m, l), sl in zip(halves, (slice(0, 77), slice(77, None))):
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


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 3, 8, 16, 128, 128),
                                   (2, 2, 13, 21, 256, 128),
                                   (1, 2, 9, 9, 128, 256)])
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("m,k,n,bias,act", [
    (2, 512, 384, True, None),          # the modulation matvec shape class
    (77, 256, 256, False, None),        # ragged rows
    (300, 512, 640, True, "gelu_tanh"),  # fc1 with the fused activation
    (129, 256, 128, True, "gelu"),
    (64, 256, 256, True, "relu"),
    (1, 384, 256, False, "silu"),
])
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


def test_w8a8_kernel_strided_slices(dev):
    """Column and row slices of one weight (the single block's linear1 /
    linear2 slices) reach the kernel as strided views, [B, L, K] inputs."""
    from hunyuanvideo_efficiency_tpu_torch.ops.int8_matmul import (
        w8a8_linear, w8a8_linear_plain)
    from hunyuanvideo_efficiency_tpu_torch.ops.quantization import (
        quantize_tensor_int8)

    g = torch.Generator(dev).manual_seed(6)
    w8, so = quantize_tensor_int8(torch.randn(768, 512, generator=g,
                                              device=dev))
    x = torch.randn(2, 45, 256, generator=g, device=dev).bfloat16()
    for out_sl, in_sl in ((slice(128, 512), slice(0, 256)),
                          (slice(0, 768), slice(256, 512))):
        wv = w8[out_sl, in_sl]
        out = w8a8_linear(x, wv, so[out_sl])
        ref = w8a8_linear_plain(x, wv, so[out_sl])
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


BACKWARD_CASES = [(200, 200, 13), (77, 333, 0), (333, 77, 20), (1000, 1000, 5)]


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
