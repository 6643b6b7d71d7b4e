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
