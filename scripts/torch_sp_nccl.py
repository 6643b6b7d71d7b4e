"""Sequence-parallel sampling and training of the PyTorch port across
ranks, one GPU a rank over NCCL (or one CPU process a rank over gloo with
--device cpu).

    torchrun --nproc_per_node 4 scripts/torch_sp_nccl.py
    torchrun --nproc_per_node 4 scripts/torch_sp_nccl.py --phases train
    torchrun --nproc_per_node 4 scripts/torch_sp_nccl.py --phases tiers
    torchrun --nproc_per_node 4 scripts/torch_sp_nccl.py --device cpu --tiny

Every rank draws the same full inputs from fixed seeds and keeps its shard,
so rank 0 can hold the gathered result to one single-device call:

1. attention: `usp_joint_attention` at full width (24 heads x 128, bf16)
   for every (ulysses, ring) factorization of the world size, on the dense
   main path's 4,032 + 256 tokens (B = 2, the flash kernels: K1, with state
   on the ring; and under flash_int8, B8a, with state on the ring) and
   under STA on the 16x34x60 grid (B4 on each rank's head group, or on its
   halo-extended slab); the image output all-gathered and put back in
   token order, the text output of every rank, against the single-device
   `joint_attention` on rank 0 (max relative error 2e-2; flash_int8
   against the exact K1 call, 3e-2, JAX's int8 tolerance). Times: the
   median over ITERS calls of the slowest rank's CUDA-event time of a call
   (collectives included), beside the single call's median; then one call
   under torch.profiler, rank 0's device time by category (attention
   kernels, NCCL kernels with their waits for the peers, copies and cat,
   the rest: the state merges and other elementwise work).
2. predict: HunyuanVideoSampler at the full width and depth of HYVideo-T/2
   (random weights, the adaLN layers randomized), two videos of
   256x448x33f, 2 steps, CFG 6.0, under several layouts (dp x ulysses x
   ring), each against the same predict on rank 0 alone (relative L2 of
   the float video 2e-2), with the median of PREDICT_ITERS runs' seconds
   per run (the slowest rank's); then one request in lockstep as serve.py
   runs it (rank 0 broadcasting the arguments). The towers and the decode
   stay replicated here (`memory_tiers=False`), so that rank 0 can run
   alone; the tiers phase runs them sharded.
3. train: the sharded SGD step (training.make_train_step with sp) of a
   trainable DiT at the full width and depth of HYVideo-T/2 (bf16, the
   adaLN layers randomized, every block checkpointed) on 256x448x33f
   latents, two steps under each layout (ulysses, ulysses x ring, ring,
   and dp x ulysses at batch 2), each against rank 0 running the
   one-device step on the same global batch from the same weights: both
   losses (relative 1e-2) and every parameter (relative L2 of the whole
   set, 2e-2; the relative L2 of the update beside it as information),
   every rank's parameters equal to rank 0's bit for bit; the slowest
   rank's seconds a step (host clock, synchronized) and its peak GiB.
4. tiers: the scale-out memory tiers (inference.py) at full width and
   depth, 256x448x33f, two videos, 2 steps, CFG 6.0: first every rank
   builds the replicated sampler (no tiers) and rank 0 alone predicts, the
   reference; then a sampler with every tier (--shard-dit-weights over the
   sp group, the Llama tower tensor-parallel and the tiled decode spread
   over the world) predicts under u = 4 and u2 x r2, each held to rank 0
   alone (relative L2 2e-2); then the same layouts without
   --shard-dit-weights, each equal to the sharded run bit for bit. Each
   build prints every rank's peak GiB right after loading and its
   resident DiT, tower and VAE GiB; each predict the slowest rank's median
   gen_s and decode_s. Before the layouts, one predict at the headline,
   720x1280x129f, 1 step, u = 4, all tiers: each rank's peak GiB, s/step,
   decode s and text-encode s, or, when a rank runs out of memory, where.
One line per check; the last line is {"ok": true, ...} on rank 0.
`--phases` picks among attention, predict, train and tiers (default:
attention, predict, train); `--tiny` shrinks every shape (a CPU
rehearsal).
"""
import argparse
import datetime
import gc
import itertools
import json
import math
import os
import statistics
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hunyuanvideo_efficiency_tpu_torch import serve  # noqa: E402
from hunyuanvideo_efficiency_tpu_torch.config import InferenceArgs  # noqa
from hunyuanvideo_efficiency_tpu_torch.inference import (  # noqa: E402
    HunyuanVideoSampler)
from hunyuanvideo_efficiency_tpu_torch.models.dit_config import (  # noqa
    DiTConfig)
from hunyuanvideo_efficiency_tpu_torch.ops import cuda_lib  # noqa: E402
from hunyuanvideo_efficiency_tpu_torch.ops.attention import (  # noqa: E402
    joint_attention)
from hunyuanvideo_efficiency_tpu_torch.models import dit as dit_mod  # noqa
from hunyuanvideo_efficiency_tpu_torch.ops.rope import (  # noqa: E402
    get_nd_rotary_pos_embed)
from hunyuanvideo_efficiency_tpu_torch.parallel import (  # noqa: E402
    ParallelConfig, initialize_multihost, make_groups, usp_joint_attention)
from hunyuanvideo_efficiency_tpu_torch.parallel.sp_train import (  # noqa
    broadcast_params)
from hunyuanvideo_efficiency_tpu_torch.training import (  # noqa: E402
    make_train_step)
from hunyuanvideo_efficiency_tpu_torch.utils.profiling import (  # noqa
    PhaseTimer, device_ms_by_category)
from hunyuanvideo_efficiency_tpu_torch.utils.seeded import (  # noqa: E402
    joint_inputs, randomize_modulation)

ITERS = 10          # timed calls of each attention layout
PREDICT_ITERS = 5   # timed predict runs of each layout
TRAIN_STEPS, TRAIN_LR = 2, 0.1
TRAIN_LATENT = (16, 9, 32, 56)       # 256x448x33f: a 9x16x28 patch grid
TIER_ITERS = 3      # timed predict runs of each layout with the tiers
HEADLINE = dict(height=720, width=1280, video_length=129)


def log(rank, tag, **fields):
    if rank == 0:
        print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
              flush=True)


def rel_err(out, ref):
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def timed(fn, dev):
    """fn's result and its time in ms (CUDA events, or the host clock)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(dev)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(dev)
    return out, start.elapsed_time(end)


_GROUPS = {}


def groups_of(layout):
    """The subgroups of a (dp, ulysses, ring) layout, built once for the
    run (every rank reaches the layouts in the same order)."""
    if layout not in _GROUPS:
        _GROUPS[layout] = make_groups(ParallelConfig(*layout))
    return _GROUPS[layout]


def median_ms(fn, dev, iters, every_rank=True):
    """fn's result and the median over `iters` calls (after one warm-up)
    of a call's time in ms: the slowest rank's when every rank calls it,
    else this rank's."""
    out = fn()
    ms = []
    for _ in range(iters):
        out, t = timed(fn, dev)
        ms.append(t)
    ms = torch.tensor(ms, device=dev)
    if every_rank:
        dist.all_reduce(ms, op=dist.ReduceOp.MAX)
    return out, statistics.median(ms.tolist())


def check_attention(dev, dtype, world, rank, tiny):
    heads, d = (4, 64) if tiny else (24, 128)
    cases = [("dense", "auto", 4032 if not tiny else 96, None),
             ("dense", "flash_int8", 4032 if not tiny else 96, None),
             ("sta", "sta", None, (16, 8, 8) if tiny else (16, 34, 60))]
    tile, window = ((4, 4, 4), (3, 3, 3)) if tiny else ((4, 8, 8), (3, 3, 3))
    exact = {}
    for name, mode, n_img, grid in cases:
        n_img = n_img or math.prod(grid)
        img, txt, tb, c = joint_inputs(dev, 31, n_img, h=heads, d=d,
                                       dtype=dtype)
        kw = dict(attn_mode=mode, bound_mode="static", score_bound=c,
                  token_grid=grid, sta_tile=tile, sta_window=window)
        ref = single_ms = None
        if rank == 0:
            ref, single_ms = median_ms(lambda: joint_attention(
                *img, *txt, tb, mode=mode, bound_mode="static",
                score_bound=c, token_grid=grid, sta_tile=tile,
                sta_window=window), dev, ITERS, every_rank=False)
        tol = 2e-2
        if mode == "flash_int8":    # int8 Q.K^T: held to the exact call
            ref, tol = exact[name], 3e-2
        exact[name] = ref
        for u in (d_ for d_ in (1, 2, 4, 8) if world % d_ == 0):
            r = world // u
            pcfg = ParallelConfig(1, u, r)
            if heads % u or (name == "sta" and r > 1 and (
                    grid[0] % (r * tile[0]) or grid[0] // r < tile[0])):
                continue
            g = groups_of((1, u, r))
            toks = g.token_range(n_img)
            local = [x[:, toks] for x in img]

            def call():
                return usp_joint_attention(*local, *txt, tb, g, **kw)

            (img_out, txt_out), ms = median_ms(call, dev, ITERS)
            cats = (device_ms_by_category(call) if dev.type == "cuda"
                    else None)
            parts = [torch.empty_like(img_out) for _ in range(world)]
            dist.all_gather(parts, img_out.contiguous())
            txts = [torch.empty_like(txt_out) for _ in range(world)]
            dist.all_gather(txts, txt_out.contiguous())
            if rank == 0:
                blocks = [None] * world
                for k, part in enumerate(parts):
                    _, i, j = pcfg.coords(k)
                    blocks[pcfg.token_block(i, j)] = part
                err = max([rel_err(torch.cat(blocks, 1), ref[0])]
                          + [rel_err(t, ref[1]) for t in txts])
                if err > tol:
                    raise AssertionError(f"attention {name} {mode} u={u} "
                                         f"r={r}: max rel error {err} > "
                                         f"{tol}")
                log(rank, "sp_attention", case=name, mode=mode, ulysses=u,
                    ring=r, tokens=f"{n_img}+256", heads=heads,
                    max_rel_err=err, tol=f"rel {tol}",
                    sp_ms_median=ms, single_ms_median=single_ms,
                    iters=ITERS, rank0_device_ms=json.dumps(cats),
                    grid=json.dumps(grid))
            dist.barrier()


def tiny_registry():
    """Tiny DiT, VAE (32-pixel tiles, so the decode tiles) and towers for
    the CPU rehearsal; the Llama's heads divide 2 and 4 (tensor
    parallelism)."""
    from hunyuanvideo_efficiency_tpu_torch import inference
    from hunyuanvideo_efficiency_tpu_torch.models.text import (
        CLIPTextConfig, LlamaConfig)
    from hunyuanvideo_efficiency_tpu_torch.models.vae_config import (
        VAEConfig)

    inference.load_dit_config = lambda name, **o: DiTConfig(
        hidden_size=128, heads_num=4, mm_double_blocks_depth=1,
        mm_single_blocks_depth=1, rope_dim_list=(8, 12, 12),
        text_states_dim=64, text_states_dim_2=48, **o)
    inference.load_vae_config = lambda name: VAEConfig(
        block_out_channels=(32, 32, 64, 64), layers_per_block=1,
        sample_size=32, sample_tsize=8)
    over = dict(precision="fp32", vae_precision="fp32",
                text_encoder_precision="fp32", text_states_dim=64,
                text_states_dim_2=48)
    return over, dict(llm_config=LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=8,
        num_key_value_heads=4), clip_config=CLIPTextConfig(
        vocab_size=96, hidden_size=48, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=77, eos_token_id=95))


def check_predict(device, world, rank, tiny):
    layouts = [(1, world, 1), (1, world // 2, 2), (2, world // 2, 1)]
    if tiny:
        layouts = [(1, 2, world // 2), (2, 1, world // 2)]
    layouts = [lay for lay in layouts if math.prod(lay) == world]
    over, kw = tiny_registry() if tiny else ({}, {})
    args = InferenceArgs(model="HYVideo-T/2", vae_tiling=not tiny,
                         model_base="ckpts-not-present", device=device,
                         mesh_shape="dp:{},ulysses:{},ring:{}".format(
                             *layouts[0]), **over)
    sampler = HunyuanVideoSampler.from_pretrained(
        args=args, allow_random_init=True, memory_tiers=False, **kw)
    randomize_modulation(sampler.transformer, 3)
    size = dict(height=32, width=64, video_length=5) if tiny else dict(
        height=256, width=448, video_length=33)
    req = dict(prompt="A cat walks on the grass, realistic style.", seed=42,
               infer_steps=2, guidance_scale=6.0, flow_shift=7.0,
               num_videos_per_prompt=2, **size)
    dev = torch.device(sampler.device)

    ref = single_s = None
    if rank == 0:
        sampler.pipeline.sp = None
        single = sampler.predict(**req)              # warm-up
        ref = single["samples"]
        single_s = statistics.median(sampler.predict(**req)["gen_time"]
                                     for _ in range(PREDICT_ITERS))
    dist.barrier()
    for lay in layouts:
        sampler.pipeline.sp = groups_of(tuple(lay))
        out = sampler.predict(**req)                 # warm-up
        secs = torch.tensor([sampler.predict(**req)["gen_time"]
                             for _ in range(PREDICT_ITERS)], device=dev)
        dist.all_reduce(secs, op=dist.ReduceOp.MAX)
        if rank == 0:
            err = ((out["samples"] - ref).norm() / ref.norm()).item()
            if not err <= 2e-2 or ref.std().item() == 0:
                raise AssertionError(f"predict {lay}: rel L2 {err} > 2e-2")
            log(rank, "sp_predict", layout="dp:{},ulysses:{},ring:{}".format(
                *lay), size="{height}x{width}x{video_length}".format(**size),
                steps=2, rel_l2_vs_single=err,
                sp_gen_s_median=statistics.median(secs.tolist()),
                single_gen_s_median=single_s, runs=PREDICT_ITERS)
        dist.barrier()
    # one request as serve.py runs it: rank 0 broadcasts, the others follow
    if rank == 0:
        out = serve.run_predict(sampler, serve.request_kwargs(
            {"prompt": req["prompt"], "seed": 42, "infer_steps": 2,
             "guidance_scale": 6.0, "num_videos": 2, **size}))
        serve._broadcast(None, sampler)
        err = ((out["samples"] - ref).norm() / ref.norm()).item()
        if not err <= 2e-2:
            raise AssertionError(f"lockstep request: rel L2 {err}")
        log(rank, "sp_serve_lockstep", ranks=world, rel_l2_vs_single=err,
            gen_s=out["gen_time"])
    else:
        serve.follow(sampler)
    dist.barrier()


def resident_gib(module) -> float:
    """GiB of the module's own storages, each once (a tower shard's shared
    embedding, the block views of a weight-sharded DiT's transient buffer),
    plus a weight-sharded DiT's kept shards."""
    seen = {}
    for t in itertools.chain(module.parameters(), module.buffers()):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    shards = getattr(module, "weight_shards", None)
    return (sum(seen.values())
            + (shards.shard_bytes if shards is not None else 0)) / 2**30


def peak_gib(dev) -> float:
    return (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else 0.0)


def timed_predict(sampler, req, dev):
    """predict with its decode split off (the host clock from the last
    step's callback to the end, synchronized) and its per-step times."""
    marks = []

    def on_step(i, latents):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        marks.append(time.time())

    t0 = time.time()
    out = sampler.predict(**req, progress_callback=on_step)
    end = time.time()
    steps = [b - a for a, b in zip([t0] + marks, marks)]
    return out, dict(gen_s=out["gen_time"], decode_s=end - marks[-1],
                     step_s=steps)


def check_tiers(device, world, rank, tiny, headline):
    """The memory tiers at full width and depth; see the module docstring
    (4)."""
    dev = torch.device(device)
    over, kw = tiny_registry() if tiny else ({}, {})
    layouts = [(1, world, 1), (1, world // 2, 2)]
    size = dict(height=32, width=64, video_length=5) if tiny else dict(
        height=256, width=448, video_length=33)
    req = dict(prompt="A cat walks on the grass, realistic style.", seed=42,
               infer_steps=2, guidance_scale=6.0, flow_shift=7.0,
               num_videos_per_prompt=2, **size)

    def build(shard, tiers):
        args = InferenceArgs(model="HYVideo-T/2", vae_tiling=True,
                             model_base="ckpts-not-present", device=device,
                             mesh_shape="dp:{},ulysses:{},ring:{}".format(
                                 *layouts[0]),
                             shard_dit_weights=shard, **over)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        sampler = HunyuanVideoSampler.from_pretrained(
            args=args, allow_random_init=True, memory_tiers=tiers,
            modulation_seed=3, **kw)
        mem = torch.tensor([peak_gib(dev), resident_gib(sampler.transformer),
                            resident_gib(sampler.text_encoder.model),
                            resident_gib(sampler.vae),
                            resident_gib(sampler.text_encoder_2.model),
                            time.time() - t0], device=dev)
        parts = [torch.empty_like(mem) for _ in range(world)]
        dist.all_gather(parts, mem)
        log(rank, "tiers_build", shard_dit_weights=shard, tiers=tiers,
            peak_after_load_gib=json.dumps([p[0].item() for p in parts]),
            dit_gib=json.dumps([p[1].item() for p in parts]),
            llama_gib=json.dumps([p[2].item() for p in parts]),
            vae_gib=parts[0][3].item(), clip_gib=parts[0][4].item(),
            build_s=max(p[5].item() for p in parts))
        return sampler

    def run_layouts(sampler, label, ref, equal_to=None):
        outs = {}
        for lay in layouts:
            sampler.pipeline.sp = groups_of(tuple(lay))
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            out, t = timed_predict(sampler, req, dev)
            runs = [t] + [timed_predict(sampler, req, dev)[1]
                          for _ in range(TIER_ITERS - 1)]
            slow = torch.tensor([[r["gen_s"], r["decode_s"]] for r in runs],
                                device=dev)
            dist.all_reduce(slow, op=dist.ReduceOp.MAX)
            peak = torch.tensor([peak_gib(dev)], device=dev)
            peaks = [torch.empty_like(peak) for _ in range(world)]
            dist.all_gather(peaks, peak)
            samples = out["samples"]
            if rank == 0:
                err = ((samples - ref).norm() / ref.norm()).item()
                fields = {}
                if equal_to is not None:
                    same = torch.equal(samples.cpu(), equal_to[lay])
                    fields["bit_equal_to_sharded"] = same
                    if not same:
                        raise AssertionError(f"tiers {label} {lay}: not "
                                             f"bit-equal to the sharded run")
                if not err <= 2e-2:
                    raise AssertionError(f"tiers {label} {lay}: rel L2 "
                                         f"{err} > 2e-2")
                log(rank, "tiers_predict", case=label,
                    layout="dp:{},ulysses:{},ring:{}".format(*lay),
                    size="{height}x{width}x{video_length}".format(**size),
                    steps=2, videos=2, rel_l2_vs_rank0_alone=err,
                    gen_s_median=statistics.median(slow[:, 0].tolist()),
                    decode_s_median=statistics.median(slow[:, 1].tolist()),
                    peak_gib=json.dumps([p.item() for p in peaks]),
                    runs=TIER_ITERS, **fields)
                outs[lay] = samples.cpu()
            dist.barrier()
        return outs

    # the reference: every module replicated, rank 0 alone
    sampler = build(False, False)
    ref = None
    if rank == 0:
        sampler.pipeline.sp = None
        sampler.predict(**req)                        # warm-up
        out, t = timed_predict(sampler, req, dev)
        ref = out["samples"]
        log(rank, "tiers_single", gen_s=t["gen_s"], decode_s=t["decode_s"],
            peak_gib=peak_gib(dev))
    dist.barrier()
    del sampler
    sampler = build(True, True)
    if headline:
        check_headline(sampler, dev, world, rank, dict(
            height=64, width=96, video_length=9) if tiny else HEADLINE)
    sharded = run_layouts(sampler, "all tiers", ref)
    del sampler
    sampler = build(False, True)
    run_layouts(sampler, "tiers without --shard-dit-weights", ref, sharded)
    del sampler


def check_headline(sampler, dev, world, rank, size):
    """One predict of `size` (HEADLINE: 720x1280x129f), 1 step, u = world,
    every tier: each rank's peak GiB, s/step, decode s and text-encode s;
    a rank that runs out of memory says where before the run fails."""
    sampler.pipeline.sp = groups_of((1, world, 1))
    req = dict(prompt="A cat walks on the grass, realistic style.", seed=42,
               infer_steps=1, guidance_scale=6.0, flow_shift=7.0,
               num_videos_per_prompt=1, **size)
    where = "text"
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        t0 = time.time()
        sampler.pipeline.encode_prompt(req["prompt"],
                                       sampler.default_negative_prompt, True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        text_s = time.time() - t0
        where = "predict"
        out, t = timed_predict(sampler, req, dev)
    except torch.cuda.OutOfMemoryError as e:
        print(f"[tiers_headline] rank={rank} out_of_memory_in={where} "
              f"peak_gib={peak_gib(dev)} error={json.dumps(str(e)[:300])}",
              flush=True)
        raise
    row = torch.tensor([peak_gib(dev), t["step_s"][0] - text_s,
                        t["decode_s"], text_s, t["gen_s"]], device=dev)
    rows = [torch.empty_like(row) for _ in range(world)]
    dist.all_gather(rows, row)
    v = out["samples"]
    ok = bool(torch.isfinite(v).all()) and v.std().item() > 0
    log(rank, "tiers_headline",
        size="{height}x{width}x{video_length}".format(**size), steps=1,
        layout=f"dp:1,ulysses:{world},ring:1", videos=1, cfg=True,
        finite_nonconstant=ok, shape=json.dumps(list(v.shape)),
        peak_gib=json.dumps([r[0].item() for r in rows]),
        s_per_step=max(r[1].item() for r in rows),
        decode_s=max(r[2].item() for r in rows),
        text_encode_s=max(r[3].item() for r in rows),
        gen_s=max(r[4].item() for r in rows),
        note="s_per_step is the first step less a separate text encode")
    if not ok:
        raise AssertionError("headline video is not finite or is constant")
    del out, v


def train_inputs(cfg, latent, batch, seed, dev, txt_len=256, txt_valid=40):
    """One global training batch, the same on every rank (a CPU generator):
    clean latents, noise, t, text states with `txt_valid` valid tokens, the
    pooled text vector and the grid RoPE tables."""
    g = torch.Generator().manual_seed(seed)
    x0 = torch.randn(batch, *latent, generator=g)
    noise = torch.randn(batch, *latent, generator=g)
    t = torch.rand(batch, generator=g)
    pe = torch.randn(batch, txt_len, cfg.text_states_dim, generator=g)
    mask = torch.ones(batch, txt_len, dtype=torch.long)
    mask[:, txt_valid:] = 0
    pe2 = torch.randn(batch, cfg.text_states_dim_2, generator=g)
    grid = tuple(n // p for n, p in zip(latent[1:], cfg.patch_size))
    cos, sin = get_nd_rotary_pos_embed(cfg.rope_dim_list, grid,
                                       theta=cfg.rope_theta, device="cpu")
    return [x.to(dev) for x in (x0, noise, t, pe, mask, pe2,
                                cos.reshape(*grid, -1),
                                sin.reshape(*grid, -1))]


def check_train(dev, world, rank, tiny):
    """Two sharded SGD steps a layout against rank 0's one-device steps."""
    if tiny:
        cfg = DiTConfig(hidden_size=128, heads_num=4, mm_double_blocks_depth=1,
                        mm_single_blocks_depth=1, rope_dim_list=(8, 12, 12),
                        text_states_dim=64, text_states_dim_2=48,
                        attn_mode="flash")
        latent, dtype, txt_len = (16, 4, 8, 8), torch.float32, 16
    else:
        cfg, latent, dtype, txt_len = DiTConfig(), TRAIN_LATENT, \
            torch.bfloat16, 256
    layouts = [(1, world, 1), (1, world // 2, 2), (1, 1, world),
               (2, world // 2, 1)]
    layouts = [lay for lay in layouts if math.prod(lay) == world]
    model = dit_mod.build_dit(cfg, dev, dtype, trainable=True)

    def init():
        model.init_weights(torch.Generator(dev).manual_seed(20))
        randomize_modulation(model, 21)

    def steps(batch, sp):
        init()      # the same initial weights each time, on every rank
        if sp is not None:
            broadcast_params(model)
        step = make_train_step(model, lr=TRAIN_LR, sp=sp)
        data = train_inputs(cfg, latent, batch, 22, dev, txt_len)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        losses, secs = [], []
        for _ in range(TRAIN_STEPS):
            loss, ms = timed(lambda: step(*data), dev)
            losses.append(float(loss))
            secs.append(ms / 1e3)
        peak = (torch.cuda.max_memory_allocated(dev) / 2**30
                if dev.type == "cuda" else 0.0)
        return losses, secs, peak

    single = {}
    if rank == 0:     # the one-device reference of each batch size
        init()
        single["init"] = [p.detach().to("cpu", copy=True)
                          for p in model.parameters()]
        for batch in sorted({lay[0] for lay in layouts}):
            losses, secs, peak = steps(batch, None)
            single[batch] = (losses, secs, peak, [
                p.detach().to("cpu", copy=True) for p in model.parameters()])
    dist.barrier()
    for lay in layouts:
        g = groups_of(tuple(lay))
        losses, secs, peak = steps(lay[0], g)
        slow = torch.tensor(secs + [peak], device=dev)
        dist.all_reduce(slow, op=dist.ReduceOp.MAX)
        same = 1.0      # this rank's parameters against rank 0's, bitwise
        for p in model.parameters():
            ref = p.detach().clone()
            dist.broadcast(ref, src=0)
            same = min(same, float(torch.equal(p.detach(), ref)))
        same = torch.tensor(same, device=dev)
        dist.all_reduce(same, op=dist.ReduceOp.MIN)
        if rank == 0:
            s_losses, s_secs, s_peak, s_params = single[lay[0]]
            loss_err = max(abs(a - b) / abs(b)
                           for a, b in zip(losses, s_losses))
            num = den = upd = 0.0
            for p, w, p0 in zip(model.parameters(), s_params,
                                single["init"]):
                w, p0 = w.to(dev).float(), p0.to(dev).float()
                num += (p.detach().float() - w).square().sum().item()
                den += w.square().sum().item()
                upd += (w - p0).square().sum().item()
            rel_l2 = math.sqrt(num / den)
            upd_rel_l2 = math.sqrt(num / max(upd, 1e-30))
            if not (loss_err <= 1e-2 and rel_l2 <= 2e-2
                    and same.item() == 1.0):
                raise AssertionError(
                    f"train {lay}: loss rel {loss_err} (1e-2), params rel "
                    f"L2 {rel_l2} (2e-2), ranks equal {same.item()}")
            log(rank, "sp_train", layout="dp:{},ulysses:{},ring:{}".format(
                *lay), blocks=f"{cfg.mm_double_blocks_depth}+"
                f"{cfg.mm_single_blocks_depth}", latent=json.dumps(latent),
                batch=lay[0], losses=json.dumps(losses),
                single_losses=json.dumps(s_losses), loss_rel_err=loss_err,
                param_rel_l2=rel_l2, update_rel_l2=upd_rel_l2,
                ranks_bit_equal=bool(same.item()),
                slowest_s_per_step=json.dumps(slow[:-1].tolist()),
                slowest_peak_gib=slow[-1].item(),
                single_s_per_step=json.dumps(s_secs),
                single_peak_gib=s_peak, lr=TRAIN_LR,
                tol="loss rel 1e-2, params rel L2 2e-2")
        dist.barrier()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--phases", default="attention,predict,train",
                   help="comma-separated: attention, predict, train, tiers")
    p.add_argument("--no-headline", action="store_true",
                   help="tiers: skip the 720x1280x129f predict")
    p.add_argument("--pg-timeout", type=float, default=None,
                   help="seconds a collective may wait for its peers "
                        "before the run fails (default: the backend's)")
    a = p.parse_args(argv)
    device = initialize_multihost(a.device, None if a.pg_timeout is None
                                  else datetime.timedelta(
                                      seconds=a.pg_timeout))
    if not dist.is_initialized():
        raise SystemExit("run under torchrun --nproc_per_node N (N > 1)")
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device(device)
    t0 = time.time()
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        if rank == 0:
            cuda_lib.build()
        dist.barrier()
    log(rank, "env", world=world, backend=dist.get_backend(),
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu", torch=torch.__version__)
    dtype = torch.float32 if a.tiny else torch.bfloat16
    phases = a.phases.split(",")
    timer = PhaseTimer()
    with torch.no_grad():
        if "attention" in phases:
            with timer.phase("attention"):
                check_attention(dev, dtype, world, rank, a.tiny)
        if "predict" in phases:
            with timer.phase("predict"):
                check_predict(device, world, rank, a.tiny)
        if "tiers" in phases:
            with timer.phase("tiers"):
                check_tiers(device, world, rank, a.tiny, not a.no_headline)
    if "train" in phases:
        with timer.phase("train"):
            check_train(dev, world, rank, a.tiny)
    log(rank, "total", seconds=time.time() - t0, phases=json.dumps(
        timer.summary()))
    if rank == 0:
        print(json.dumps({"ok": True, "world": world,
                          "backend": dist.get_backend()}))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
