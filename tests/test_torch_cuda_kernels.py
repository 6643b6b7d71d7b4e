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
