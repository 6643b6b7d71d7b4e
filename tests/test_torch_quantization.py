"""The port's weight tiers (ops/quantization.py, utils/checkpoint.py)
against the JAX package's on the CPU: codes and scales of every tier equal
bit for bit (fp8 compared as uint8 views), the stacked fp8 -> int8 -> int4
converter order on a tiny DiT, and the fp8 loader on a synthetic reference
checkpoint plus scale map written here.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.models.dit import init_dit_params
from hunyuanvideo_efficiency_tpu.models.dit_config import DiTConfig as JCfg
from hunyuanvideo_efficiency_tpu.ops import quantization as jq
from hunyuanvideo_efficiency_tpu.utils.checkpoint import (
    load_fp8_dit_checkpoint as jax_load_fp8)
from hunyuanvideo_efficiency_tpu_torch.models.dit import HYVideoDiT
from hunyuanvideo_efficiency_tpu_torch.models.dit_config import DiTConfig
from hunyuanvideo_efficiency_tpu_torch.ops import quantization as q
from hunyuanvideo_efficiency_tpu_torch.ops.int8_matmul import quantize_rows
from hunyuanvideo_efficiency_tpu_torch.utils.checkpoint import (
    fp8_map_path, load_fp8_dit_checkpoint)
from hunyuanvideo_efficiency_tpu_torch.utils.weights import (
    dit_state_dict_from_jax)

TINY = dict(hidden_size=128, heads_num=4, mm_double_blocks_depth=2,
            mm_single_blocks_depth=2, rope_dim_list=(8, 12, 12),
            text_states_dim=64, text_states_dim_2=32)


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bytes of a tensor (fp8 as uint8)."""
    if t.dtype == torch.float8_e4m3fn:
        t = t.view(torch.uint8)
    return t.numpy()


def _weight(seed, shape=(96, 64), dtype=np.float32):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    w[3, 5] = 0.4           # an outlier column and row
    return w.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_tiers_match_jax_bitwise(dtype):
    """w is a JAX kernel [in, out]; the port quantizes its transpose."""
    w = _weight(0)
    wj = jnp.asarray(w, dtype)
    wt = torch.from_numpy(w.T.copy()).to(getattr(torch, dtype))

    ref = jq.quantize_tensor_fp8(wj, stacked=False)
    codes, scale = q.quantize_tensor_fp8(wt)
    assert codes.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(
        _bits(codes), np.asarray(ref["kernel"]).view(np.uint8).T)
    assert scale.item() == float(ref["scale"])

    ref = jq.quantize_tensor_int8(wj)
    codes, scale = q.quantize_tensor_int8(wt)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref["kernel"]).T)
    np.testing.assert_array_equal(scale.numpy(),
                                  np.asarray(ref["scale_out"])[0])

    ref = jq.quantize_tensor_int4(wj)
    packed, scale = q.quantize_tensor_int4(wt)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(ref["kernel_i4"]).T)
    np.testing.assert_array_equal(scale.numpy(),
                                  np.asarray(ref["scale_out"])[0])
    np.testing.assert_array_equal(
        q.dequantize_int4(packed, scale, torch.float32).numpy(),
        np.asarray(jq.dequantize_int4(ref, jnp.float32)).T)


@functools.lru_cache(maxsize=None)
def _jax_dit(seed=0):
    """(numpy params, cfg) of a tiny JAX DiT; callers do not mutate them."""
    jcfg = JCfg(**{"attn_mode": "flash", **TINY})
    params = jax.tree.map(np.asarray,
                          init_dit_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    # the zero-initialized adaLN layers get values, so int4 sees real data
    params = jax.tree.map(
        lambda a: a if np.any(a) else
        (rng.standard_normal(a.shape) * 0.05).astype(a.dtype), params)
    return params, jcfg


TIERS = [c for n in (1, 2, 3)
         for c in itertools.combinations(("fp8", "int8", "int4"), n)]


@pytest.mark.parametrize("tiers", TIERS, ids="+".join)
def test_dit_converters_stack_like_jax(tiers):
    """JAX quantize_dit_params_{fp8,int8,int4_modulation} in the order of
    its inference.py against quantize_dit on the same weights: every
    tensor of the state dict equal bit for bit."""
    params, _ = _jax_dit()
    cfg = DiTConfig(**TINY)
    model = HYVideoDiT(cfg).eval()
    model.load_state_dict(dit_state_dict_from_jax(params, cfg))
    jp = jax.tree.map(jnp.asarray, params)
    if "fp8" in tiers:
        jp = jq.quantize_dit_params_fp8(jp)
    if "int8" in tiers:
        jp = jq.quantize_dit_params_int8(jp)
    if "int4" in tiers:
        jp = jq.quantize_dit_params_int4_modulation(jp)
    q.quantize_dit(model, fp8="fp8" in tiers, int8="int8" in tiers,
                   int4_modulation="int4" in tiers)
    want = dit_state_dict_from_jax(jax.tree.map(np.asarray, jp), cfg)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=key)
    mod = model.double_blocks[0].img_mod.linear
    expect = (q.Int4Linear if "int4" in tiers else
              q.Int8Linear if "int8" in tiers else q.Fp8Linear)
    assert type(mod) is expect
    assert type(model.final_layer.linear) is torch.nn.Linear


def test_fp8_loader_matches_jax(tmp_path):
    """A reference-layout fp8 checkpoint (E4M3 block weights) and its
    `_map.pt` side-car, keyed by `.weight` and by `.scale` names: the port's
    loader and the JAX loader give the same codes, scales and bf16 rest."""
    params, jcfg = _jax_dit(1)
    cfg = DiTConfig(**TINY)
    model = HYVideoDiT(cfg).eval()
    model.load_state_dict(dit_state_dict_from_jax(params, cfg))
    sd, fp8_map = {}, {}
    for i, (name, t) in enumerate(model.state_dict().items()):
        if name.startswith(q.QUANT_BLOCK_KEYS) and t.ndim == 2:
            s = t.abs().amax() / 224.0
            sd[name] = (t / s).to(torch.float8_e4m3fn)
            key = name if i % 2 else name[:-len(".weight")] + ".scale"
            fp8_map[key] = s.reshape(1)
        else:
            sd[name] = t.bfloat16()
    ckpt = tmp_path / "mp_rank_00_model_states_fp8.pt"
    torch.save({"module": sd}, ckpt)
    torch.save(fp8_map, fp8_map_path(ckpt))
    assert fp8_map_path(ckpt).name == "mp_rank_00_model_states_fp8_map.pt"

    ref = jax.tree.map(np.asarray, jax_load_fp8(str(ckpt),
                                                str(fp8_map_path(ckpt)), jcfg))
    got = load_fp8_dit_checkpoint(ckpt, fp8_map_path(ckpt), cfg,
                                  device="cpu").state_dict()
    want = dit_state_dict_from_jax(ref, cfg)
    assert got.keys() == want.keys()
    n_fp8 = 0
    for key, w in want.items():
        g = got[key]
        if w.dtype == torch.float8_e4m3fn:
            n_fp8 += 1
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=key)
        else:   # the JAX tree is bf16; the carried-over copy is fp32
            np.testing.assert_array_equal(g.float().numpy(), w.numpy(),
                                          err_msg=key)
    assert n_fp8 == len(fp8_map)


def test_linear_dispatch_slices_each_tier():
    """linear() with output (column) and input (row) slices equals the
    dequantized weight sliced the same way, for every tier."""
    torch.manual_seed(0)
    lin = torch.nn.Linear(64, 96)
    x = torch.randn(3, 7, 32)
    for conv in (q.to_fp8, q.to_int8, q.to_int4, lambda m: m):
        mod = conv(lin)
        w = (mod.dense_weight() if hasattr(mod, "dense_weight")
             else mod.weight.detach())
        out, in_ = slice(32, 96), slice(32, 64)
        got = q.linear(mod, x, out=out, in_=in_, bias=False)
        if isinstance(mod, q.Int8Linear):
            xq, sx = quantize_rows(x)
            want = (xq.double() @ mod.weight[out, in_].double().t()).float() \
                * sx * mod.scale_out[out]
        else:
            want = x @ w[out, in_].t()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
