"""Shared inputs and checks of the STA tests (tests/test_torch_sta_*.py):
the geometries, the dispatch arms, numpy inputs from a seed and the
tolerance (atol 2e-5 times the output scale, rtol 1e-5: fp32 sums in
other orders)."""
import jax.numpy as jnp
import numpy as np
import torch


NEG_INF = -1e30


GEOMETRIES = [
    # grid, tile, window
    ((3, 9, 10), (2, 4, 4), (3, 3, 3)),   # ragged grid
    ((4, 8, 8), (2, 4, 4), (3, 3, 3)),
    ((4, 8, 8), (2, 4, 4), (1, 3, 3)),    # anisotropic window
]


ARMS = {
    "static_direct": dict(bound_mode="static"),
    "static_permuted_fused": dict(bound_mode="static", direct=False),
    "static_permuted_unfused": dict(bound_mode="static", fused=False),
    "running": dict(bound_mode="auto"),
}


# the quant arms (sta_int8): int8 Q.K^T with tile scales; the direct arm's
# text keys stay in the input type, the permuted arms quantize them
INT8_ARMS = {
    "int8_direct": dict(bound_mode="static", qk_int8=True),
    "int8_permuted_fused": dict(bound_mode="static", qk_int8=True,
                                direct=False),
    "int8_permuted_unfused": dict(bound_mode="static", qk_int8=True,
                                  fused=False),
}


def _inputs(grid, seed=0, b=2, h=2, d=32, lt=24, key_bias=False):
    """img q/k/v, txt q/k/v (numpy, 0.5 * N(0, 1)), a text padding bias
    [B, 1, 1, Lt] and optionally an image key bias [B, S_img]."""
    rng = np.random.default_rng(seed)
    s = grid[0] * grid[1] * grid[2]
    img = [rng.standard_normal((b, s, h, d)).astype(np.float32) * 0.5
           for _ in range(3)]
    txt = [rng.standard_normal((b, lt, h, d)).astype(np.float32) * 0.5
           for _ in range(3)]
    mask = rng.random((b, lt)) > 0.3
    mask[:, 0] = True
    tb = np.where(mask, 0.0, NEG_INF).astype(np.float32)[:, None, None, :]
    ikb = None
    if key_bias:
        ikb = np.where(rng.random((b, s)) > 0.2, 0.0, NEG_INF)
        ikb = (ikb + rng.standard_normal((b, s)) * 0.3).astype(np.float32)
    return img, txt, tb, ikb


def _torch(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


def _jax(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


def _close(out, ref):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert out.shape == ref.shape and scale > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5 * scale,
                               rtol=1e-5)
