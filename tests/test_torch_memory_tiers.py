"""The scale-out memory tiers of the port (parallel/weight_shard.py,
models/text/llama.py's tensor parallelism, models/vae.py's tile sharding,
B9's two row-parallel arms) on the CPU, in one process: every rank's
arithmetic run in turn through parallel.comm.LocalComm, the same per-rank
code that the gloo worlds of tests/test_torch_sp.py run as collectives
(where they are also held to JAX).

* the chunk plan pinned to JAX's chunking (models/dit.py:1003-1018);
* a DiT whose stacks are cut into 2 or 4 shards and gathered back chunk by
  chunk equals the replicated DiT bit for bit, in fp32, int8 and fp8 +
  int4, dense and under STA with dense anchors; one gather a chunk a dtype;
  each rank's bytes exact; `build_sharded_dit` (a chunk at a time, random
  or from a state dict, the tiers and the modulation draws during the
  build) holds the values of the replicated build;
* the tensor-parallel Llama tower over 2 and 4 ranks: int8 equal to the
  one-rank int8 tower bit for bit, fp32 within 1e-5 (the row-parallel sums
  in another order); `build_llama_tp` holds the slices of the one-rank
  build; the divisibility error;
* B9's plain arms: the given-scale and s32 arms over four K slices equal
  one call bit for bit;
* the tile-sharded VAE decode and encode over 2 and 3 ranks equal the
  one-rank tiled ones bit for bit.
"""
import types

import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu_torch.models import dit as dit_mod
from hunyuanvideo_efficiency_tpu_torch.models.dit_config import DiTConfig
from hunyuanvideo_efficiency_tpu_torch.models.text.encoder import (
    _build, build_llama_tp)
from hunyuanvideo_efficiency_tpu_torch.models.text.llama import (
    LlamaConfig, LlamaModel, check_tp_divisible, encode_shards,
    llama_rank_shards)
from hunyuanvideo_efficiency_tpu_torch.models.vae import (
    AutoencoderKLCausal3D)
from hunyuanvideo_efficiency_tpu_torch.models.vae_config import VAEConfig
from hunyuanvideo_efficiency_tpu_torch.ops.int8_matmul import (
    quantize_rows, row_scales, w8a8_linear, w8a8_linear_plain)
from hunyuanvideo_efficiency_tpu_torch.ops.quantization import (
    quantize_dit, quantize_llama_int8, quantize_tensor_int8)
from hunyuanvideo_efficiency_tpu_torch.ops.rope import get_nd_rotary_pos_embed
from hunyuanvideo_efficiency_tpu_torch.parallel.comm import (LocalComm,
                                                             tile_owner)
from hunyuanvideo_efficiency_tpu_torch.parallel.weight_shard import (
    ALIGN, WeightShards, build_sharded_dit, chunk_plan, shard_dit,
    stack_chunks)
from hunyuanvideo_efficiency_tpu_torch.utils.seeded import (
    randomize_modulation)
from test_torch_dit import TINY, dit_inputs

TIERS = {"fp32": {}, "int8": dict(int8=True),
         "fp8_int4": dict(fp8=True, int4_modulation=True)}
STA = dict(attn_mode="sta", sta_tile=(2, 2, 2), sta_window=(3, 3, 3),
           sta_dense_double_blocks=1, sta_dense_single_blocks=1)
# a GQA tower whose heads and intermediate width divide 2 and 4
LLAMA_TP = dict(vocab_size=256, hidden_size=64, intermediate_size=96,
                num_hidden_layers=2, num_attention_heads=8,
                num_key_value_heads=4)
VAE_SMALL = dict(block_out_channels=(32, 32, 64, 64), layers_per_block=1,
                 sample_size=32, sample_tsize=8)


@pytest.mark.parametrize("depth,n_dense,sta,want", [
    (20, 0, False, [(0, 5), (5, 10), (10, 15), (15, 20)]),
    (40, 0, False, [(0, 10), (10, 20), (20, 30), (30, 40)]),
    (20, 1, True, [(0, 1), (1, 6), (6, 11), (11, 16), (16, 20)]),
    (20, 1, False, [(0, 5), (5, 10), (10, 15), (15, 20)]),
    (40, 2, True, [(0, 1), (1, 2), (2, 12), (12, 22), (22, 32), (32, 40)]),
    (3, 0, False, [(0, 1), (1, 2), (2, 3)]),
])
def test_chunk_plan_is_jax_chunking(depth, n_dense, sta, want):
    """ceil(depth / 4) blocks a chunk (JAX scan_range, weight_chunks=4);
    under STA the dense head and the STA tail each on their own."""
    assert chunk_plan(depth, n_dense, sta) == want


def _dit(over=None, tiers=None, seed=0):
    cfg = DiTConfig(**{**TINY, **(over or {})})
    model = dit_mod.build_dit(cfg, "cpu", torch.float32,
                              torch.Generator().manual_seed(seed))
    quantize_dit(model, **(tiers or {}))
    randomize_modulation(model, seed + 1)
    return model


def _forward(model, grid=(3, 4, 6)):
    x, t, txt, mask, txt2 = (torch.from_numpy(a) for a in dit_inputs(
        1, grid=grid))
    sizes = (grid[0], grid[1] // 2, grid[2] // 2)
    cos, sin = get_nd_rotary_pos_embed(model.cfg.rope_dim_list, sizes,
                                       theta=model.cfg.rope_theta,
                                       device="cpu")
    with torch.no_grad():
        return model(x, t, txt, mask, txt2, cos, sin)


def _want_shard_bytes(model, world):
    """Each rank's bytes by the layout's rule, from the whole model: per
    chunk and dtype every tensor rounded up to ALIGN, the sum rounded up to
    ALIGN * world, a world-th of it."""
    total = 0
    for stack, a, b in stack_chunks(model):
        by = {}
        for blk in list(getattr(model, stack))[a:b]:
            for t in list(blk.parameters()) + list(blk.buffers()):
                nb = t.numel() * t.element_size()
                by[t.dtype] = by.get(t.dtype, 0) + -(-nb // ALIGN) * ALIGN
        total += sum(-(-n // (ALIGN * world)) * ALIGN for n in by.values())
    return total


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("tier", list(TIERS))
def test_sharded_dit_equals_replicated(world, tier):
    model = _dit(tiers=TIERS[tier])
    ref = _forward(model)
    stack = sum(t.numel() * t.element_size() for n, t in
                model.state_dict().items() if n.split(".")[0] in (
                    "double_blocks", "single_blocks"))
    want_bytes = _want_shard_bytes(model, world)
    n_dtypes = len({t.dtype for n, t in model.state_dict().items()
                    if n.startswith("double_blocks.")})
    shard_dit(model, LocalComm(world))
    shards = model.weight_shards
    assert shards.stack_bytes == stack
    assert shards.shard_bytes == want_bytes
    assert stack / world <= shards.shard_bytes < stack / world + 64 * ALIGN
    n0 = WeightShards.GATHERS
    out = _forward(model)
    # 2 + 2 blocks: one chunk a block, every chunk holds every dtype
    assert WeightShards.GATHERS - n0 == 4 * n_dtypes
    assert torch.equal(out, ref)
    assert ref.abs().max() > 1e-2


def test_sharded_dit_under_sta_anchors():
    """STA with one dense anchor a stack: head and tail chunked apart."""
    model = _dit(STA)
    grid = (4, 8, 8)
    ref = _forward(model, grid)
    shard_dit(model, LocalComm(2))
    assert sorted(model.weight_shards.start_of) == [
        ("double_blocks", 0), ("double_blocks", 1), ("single_blocks", 0),
        ("single_blocks", 1)]
    assert torch.equal(_forward(model, grid), ref)


@pytest.mark.parametrize("tier", ["fp32", "int8"])
def test_build_sharded_dit_holds_the_replicated_values(tier):
    """A chunk at a time: random weights in init_weights's order, the
    tiers, then the modulation draws; and from a state dict."""
    cfg = DiTConfig(**TINY)
    ref_model = _dit(tiers=TIERS[tier], seed=4)
    ref = _forward(ref_model)
    built = build_sharded_dit(cfg, LocalComm(2), "cpu", torch.float32,
                              generator=torch.Generator().manual_seed(4),
                              modulation_seed=5, **TIERS[tier])
    assert torch.equal(_forward(built), ref)
    plain = dit_mod.build_dit(cfg, "cpu", torch.float32,
                              torch.Generator().manual_seed(4))
    randomize_modulation(plain, 5)
    from_sd = build_sharded_dit(cfg, LocalComm(4), "cpu", torch.float32,
                                state_dict=plain.state_dict(),
                                **TIERS[tier])
    assert torch.equal(_forward(from_sd), _forward(
        quantize_dit(plain, **TIERS[tier])))


def _llama(int8, seed=2):
    cfg = LlamaConfig(**LLAMA_TP)
    model = _build(LlamaModel, cfg, "cpu", torch.float32,
                   torch.Generator().manual_seed(seed))
    return quantize_llama_int8(model) if int8 else model


def _ids(seed=3, b=2, l=12):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 256, (b, l), generator=g)
    mask = torch.ones(b, l, dtype=torch.long)
    mask[1, 7:] = 0
    return ids, mask


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_llama_tp_matches_one_rank(world, int8):
    model = _llama(int8)
    ids, mask = _ids()
    ref = model.encode(ids, mask, 1)
    comm = LocalComm(world)
    shards = llama_rank_shards(model, comm)
    assert shards[1].layers[0].self_attn.q_proj.weight.shape == (
        64 // world, 64)
    assert shards[1].embed_tokens is model.embed_tokens
    out = encode_shards(shards, comm, ids, mask, 1)
    if int8:
        assert torch.equal(out, ref)
    else:
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_build_llama_tp_holds_the_slices(int8):
    """A layer at a time, the same draws: each rank's build equals the
    one-rank build's slices."""
    cfg = LlamaConfig(**LLAMA_TP)
    full = _llama(int8)
    want = llama_rank_shards(full, LocalComm(4))
    for r in range(4):
        got = build_llama_tp(cfg, types.SimpleNamespace(rank=r, world=4),
                             "cpu", torch.float32,
                             torch.Generator().manual_seed(2),
                             quant="int8" if int8 else None)
        a, b = got.state_dict(), want[r].state_dict()
        assert list(a) == list(b)
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_int8_encoder_refuses_a_split_float_tower():
    """int8 comes before the split: a row-parallel slice quantized alone
    would take its own scale_out."""
    from hunyuanvideo_efficiency_tpu_torch.models.text.encoder import (
        TextEncoder)

    shard = llama_rank_shards(_llama(False), LocalComm(2))[0]
    with pytest.raises(ValueError, match="quantize before the split"):
        TextEncoder("llm", 16, shard, quant="int8")


def test_tp_needs_dividing_widths():
    cfg = LlamaConfig(**{**LLAMA_TP, "num_key_value_heads": 2})
    check_tp_divisible(cfg, 2)
    with pytest.raises(ValueError, match="num_key_value_heads 2 is not "
                                         "divisible by 4"):
        check_tp_divisible(cfg, 4)
    with pytest.raises(ValueError, match="intermediate_size 90"):
        check_tp_divisible(LlamaConfig(**{**LLAMA_TP,
                                          "intermediate_size": 90}), 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_row_parallel_arms_plain(dtype):
    """Four K slices, each quantized with the whole row's scale (the
    given-scale arm) and summed as s32 (the s32 arm), dequantized as the
    epilogue does: one call's result bit for bit; the s32 arm is the
    integer product of the codes."""
    g = torch.Generator().manual_seed(8)
    x = (torch.randn(6, 4 * 128, generator=g) * 3).to(dtype)
    w8, so = quantize_tensor_int8(torch.randn(256, 4 * 128, generator=g))
    sx = row_scales(torch.stack([x[:, r * 128:(r + 1) * 128].abs().amax(-1)
                                 for r in range(4)]).amax(0))
    parts = [w8a8_linear(x[:, r * 128:(r + 1) * 128],
                         w8[:, r * 128:(r + 1) * 128], so, row_scale=sx,
                         s32=True) for r in range(4)]
    assert all(p.dtype == torch.int32 for p in parts)
    out = (sum(parts).float() * sx[:, None] * so).to(dtype)
    assert torch.equal(out, w8a8_linear_plain(x, w8, so))
    xq = quantize_rows(x[:, :128], sx[:, None])[0]
    assert torch.equal(parts[0], (xq.long() @ w8[:, :128].long().t()).int())
    with pytest.raises(ValueError, match="no bias"):
        w8a8_linear(x, w8, so, so, s32=True)


def test_tile_owner_round_robin():
    assert [tile_owner(k, 4) for k in range(6)] == [0, 1, 2, 3, 0, 1]


@pytest.fixture(scope="module")
def small_vae():
    vae = AutoencoderKLCausal3D(VAEConfig(**VAE_SMALL)).eval()
    return vae.init_weights(torch.Generator().manual_seed(6))


@pytest.mark.parametrize("world", [2, 3])
def test_tile_sharded_vae_equals_one_rank(small_vae, world):
    """Spatially tiled decode (2 x 2 latent tiles of two shapes) and
    encode, each rank's tiles in turn, equal the one-rank tiled calls."""
    vae = small_vae
    g = torch.Generator().manual_seed(7)
    z = torch.randn(1, 16, 2, 5, 5, generator=g)
    x = torch.rand(1, 3, 5, 48, 48, generator=g) * 2 - 1
    vae.enable_spatial_tiling(True)
    try:
        ref_dec, ref_enc = vae.decode(z), vae.encode_moments(x)
        vae.tile_comm = LocalComm(world)
        dec, enc = vae.decode(z), vae.encode_moments(x)
    finally:
        vae.tile_comm = None
        vae.disable_tiling()
    assert torch.equal(dec, ref_dec) and torch.equal(enc, ref_enc)
