"""One rank of a gloo world for tests/test_torch_sp.py: runs every case of
its world size through the port's sequence parallelism on the CPU (sampling
and, for the "train", "adjoint" and "cli" cases, training; the memory
tiers in the "wshard", "tp", "tiles", "tiers" and "infer" cases) and writes
this rank's outputs. Imports torch and the port only.

    python tests/torch_sp_worker.py CASE_DIR WORLD RANK PORT
"""
import json
import os
import sys
import zlib

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hunyuanvideo_efficiency_tpu_torch import infer as infer_cli  # noqa
from hunyuanvideo_efficiency_tpu_torch import serve  # noqa
from hunyuanvideo_efficiency_tpu_torch import train as train_cli  # noqa
from hunyuanvideo_efficiency_tpu_torch.config import InferenceArgs  # noqa
from hunyuanvideo_efficiency_tpu_torch.diffusion.pipeline import (  # noqa
    HunyuanVideoPipeline)
from hunyuanvideo_efficiency_tpu_torch.diffusion.scheduler import (  # noqa
    FlowMatchDiscreteScheduler, get_sigmas)
from hunyuanvideo_efficiency_tpu_torch.inference import (  # noqa
    HunyuanVideoSampler)
from hunyuanvideo_efficiency_tpu_torch.models import dit as dit_mod  # noqa
from hunyuanvideo_efficiency_tpu_torch.models.dit_config import (  # noqa
    DiTConfig)
from hunyuanvideo_efficiency_tpu_torch.models.text import (  # noqa
    CLIPTextConfig, CLIPTextModel, LlamaConfig, LlamaModel, TextEncoder)
from hunyuanvideo_efficiency_tpu_torch.models.text import encoder  # noqa
from hunyuanvideo_efficiency_tpu_torch.models.text.llama import (  # noqa
    shard_llama)
from hunyuanvideo_efficiency_tpu_torch.models.vae import (  # noqa
    AutoencoderKLCausal3D)
from hunyuanvideo_efficiency_tpu_torch.models.vae_config import (  # noqa
    VAE_CONFIGS, VAEConfig)
from hunyuanvideo_efficiency_tpu_torch.ops.quantization import (  # noqa
    quantize_dit, quantize_llama_int8)
from hunyuanvideo_efficiency_tpu_torch.ops.attention import (  # noqa
    text_key_bias)
from hunyuanvideo_efficiency_tpu_torch.parallel import (  # noqa
    ParallelConfig, local_batch_slice, make_groups, usp_joint_attention)
from hunyuanvideo_efficiency_tpu_torch.parallel import (  # noqa
    sp_attention as spa)
from hunyuanvideo_efficiency_tpu_torch.parallel.comm import (  # noqa
    GroupComm)
from hunyuanvideo_efficiency_tpu_torch.parallel.weight_shard import (  # noqa
    WeightShards, shard_dit)
from hunyuanvideo_efficiency_tpu_torch.training import (  # noqa
    make_train_step, make_train_step_adamw)


TP_PROMPT = "a cat walks on the grass"


def _cfg(d):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def run_attn(case, g, inp):
    b = inp["attn_q"].shape[0]
    s = inp["attn_q"].shape[1]
    toks = g.token_range(s)
    img = [torch.from_numpy(inp[f"attn_{n}"])[:, toks] for n in "qkv"]
    txt = [torch.from_numpy(inp[f"attn_t{n}"]) for n in "qkv"]
    bias = text_key_bias(torch.from_numpy(inp["attn_mask"]))
    sta = case["mode"] == "sta"
    img_out, txt_out = usp_joint_attention(
        *img, *txt, bias, g, attn_mode=case["mode"],
        bound_mode=case.get("bound", "static" if sta else "auto"),
        token_grid=tuple(case["grid"]), sta_tile=tuple(case["tile"]),
        sta_window=tuple(case["window"]))
    assert img_out.shape[:2] == (b, toks.stop - toks.start)
    return {"img": img_out, "txt": txt_out}


def build_dit(spec, models, name):
    """The one tiny DiT's weights under the config `spec[name]`."""
    model = dit_mod.HYVideoDiT(DiTConfig(**_cfg(spec[name]))).eval()
    model.load_state_dict(models["dit"])
    return model


def run_dit(case, g, inp, spec, models, model=None):
    m = case["model"]
    model = model or build_dit(spec, models, f"dit_{m}")
    x = torch.from_numpy(inp[f"{m}_tokens"])
    rows, toks = g.batch_range(x.shape[0]), g.token_range(x.shape[1])
    out = model.forward_tokens(
        x[rows, toks], torch.from_numpy(inp[f"{m}_t"])[rows],
        torch.from_numpy(inp[f"{m}_txt"])[rows],
        torch.from_numpy(inp[f"{m}_mask"])[rows],
        torch.from_numpy(inp[f"{m}_txt2"])[rows],
        torch.from_numpy(inp[f"{m}_cos"])[toks],
        torch.from_numpy(inp[f"{m}_sin"])[toks], None,
        token_grid=tuple(case["grid"]), sp=g)
    return {"tokens": out}


def run_denoise(case, g, inp, spec, models, model=None):
    model = model or build_dit(spec, models, "dit_dense")
    pipe = HunyuanVideoPipeline(None, None, None, model,
                                FlowMatchDiscreteScheduler(), sp=g)
    sigmas, timesteps = get_sigmas(case["steps"], shift=7.0)
    f = [torch.from_numpy(inp[f"den_{n}"]) for n in ("cos", "sin")]
    lat = pipe._denoise_sharded(
        torch.from_numpy(inp["den_x"]), sigmas, timesteps,
        *(torch.from_numpy(inp[f"den_{n}"]) for n in ("txt", "mask", "txt2")),
        f, True, case["guidance_scale"], None, case["guidance_rescale"])
    return {"latents": lat}


def run_wshard(case, g, inp, spec, models):
    """The DiT forward (and, with `steps`, the denoise loop) with the block
    stacks weight-sharded over the sp group, and the same with replicated
    weights: the sharded outputs, whether they equal the replicated ones
    bit for bit, this rank's shard and stack bytes, and the gathers of one
    forward."""
    m = case["model"]
    name = {"int8": "dense"}.get(m, m)

    def make():
        model = build_dit(spec, models, f"dit_{name}")
        return quantize_dit(model, int8=True) if m == "int8" else model

    dit_case = dict(case, model=name)
    rep = make()
    ref = run_dit(dit_case, g, inp, spec, models, rep)["tokens"]
    sharded = shard_dit(make(), GroupComm(g.sp))
    ws = sharded.weight_shards
    n0 = WeightShards.GATHERS
    out = run_dit(dit_case, g, inp, spec, models, sharded)["tokens"]
    res = {"tokens": out, "equal": torch.tensor(float(torch.equal(out, ref))),
           "gathers": torch.tensor(float(WeightShards.GATHERS - n0)),
           "chunks_x_dtypes": torch.tensor(float(sum(
               len(c.buckets) for c in ws.chunks))),
           "shard_bytes": torch.tensor(float(ws.shard_bytes)),
           "stack_bytes": torch.tensor(float(ws.stack_bytes))}
    if case.get("steps"):
        lat = run_denoise(case, g, inp, spec, models, sharded)["latents"]
        lat_ref = run_denoise(case, g, inp, spec, models, rep)["latents"]
        res.update(latents=lat,
                   equal_denoise=torch.tensor(float(torch.equal(lat,
                                                                lat_ref))))
    return res


def _llama(spec, models, int8=False):
    model = LlamaModel(LlamaConfig(**spec["llama"])).eval()
    model.load_state_dict(models["llama"])
    return quantize_llama_int8(model) if int8 else model


def run_tp(case, g, inp, spec, models):
    """The Llama tower tensor-parallel over the world: fp32, and int8
    against the one-rank int8 tower of the same weights (bit for bit);
    then a TextEncoder on a tensor-parallel tower with the per-process
    salted stand-in tokenizer, and rank 0's one-rank encode of its own
    tokens."""
    comm = GroupComm()
    ids, mask = (torch.from_numpy(inp[f"tp_{n}"]).long()
                 for n in ("ids", "mask"))
    fp32 = shard_llama(_llama(spec, models), comm).encode(ids, mask, 1)
    model = _llama(spec, models, int8=True)
    one = model.encode(ids, mask, 1)
    int8 = shard_llama(model, comm).encode(ids, mask, 1)
    encoder.__dict__.pop("hash", None)
    tpl = spec["template"]
    te = TextEncoder("llm", 16, _llama(spec, models), prompt_template=tpl,
                     prompt_template_video=tpl, hidden_state_skip_layer=1)
    own = te.encode(te.text2tokens(TP_PROMPT)).hidden_state
    shard_llama(te.model, comm)
    salted = te.encode(te.text2tokens(TP_PROMPT)).hidden_state
    return {"fp32": fp32, "int8": int8,
            "int8_equal": torch.tensor(float(torch.equal(int8, one))),
            "salted": salted, "salted_own": own}


def _small_vae(spec, models):
    vae = AutoencoderKLCausal3D(VAEConfig(**_cfg(spec["vae_small"]))).eval()
    vae.load_state_dict(models["vae"])
    return vae


def run_tiles(case, g, inp, spec, models):
    """Spatially tiled decode and encode with the tiles spread over the
    world, and (rank 0) the one-rank tiled calls."""
    vae = _small_vae(spec, models)
    vae.enable_spatial_tiling(True)
    z, x = (torch.from_numpy(inp[n]) for n in ("tile_z", "tile_x"))
    out = {}
    if g.rank == 0:
        out.update(one_dec=vae.decode(z), one_enc=vae.encode_moments(x))
    vae.tile_comm = GroupComm()
    out.update(dec=vae.decode(z), enc=vae.encode_moments(x))
    return out


def run_tiers(case, g, spec, models):
    """predict with every memory tier: the weight-sharded DiT
    (--shard-dit-weights), the tensor-parallel Llama tower and the tiled
    decode spread over the world, the stand-in tokenizer on crc32."""
    encoder.hash = lambda w: zlib.crc32(w.encode())
    llama = _llama(spec, models)
    clip = CLIPTextModel(CLIPTextConfig(**spec["clip"])).eval()
    clip.load_state_dict(models["clip"])
    tpl = spec["template"]
    args = InferenceArgs(text_states_dim=64, text_states_dim_2=48,
                         vae_tiling=True, device="cpu",
                         shard_dit_weights=True,
                         mesh_shape=f"dp:{case['dp']},ulysses:{case['u']},"
                                    f"ring:{case['r']}")
    sampler = HunyuanVideoSampler(
        args, _small_vae(spec, models),
        TextEncoder("llm", 16, llama, prompt_template=tpl,
                    prompt_template_video=tpl, hidden_state_skip_layer=1),
        TextEncoder("clipL", 20, clip), build_dit(spec, models, "dit_pipe"))
    on = (sampler.transformer.weight_shards is not None
          and llama.tp is not None and sampler.vae.tile_comm is not None)
    return {"samples": sampler.predict(**case["predict"])["samples"],
            "tiers_on": torch.tensor(float(on))}


def run_infer(case, g, case_dir):
    """The infer entry with --data-parallel --enable-tiling on a small VAE
    (the registry's 884-16c-hy narrowed as in the one-rank run): rank k
    asks to write to out_r{k}; only rank 0 may."""
    VAE_CONFIGS["884-16c-hy"] = VAEConfig(**_cfg(case["vae"]))
    base = os.path.join(case_dir, case["name"])
    infer_cli.main(["--tensor-dir", os.path.join(case_dir, "infer_data"),
                    "--output-dir", os.path.join(base, f"out_r{g.rank}"),
                    "--random-init", "--device", "cpu", "--enable-tiling",
                    "--data-parallel"])
    return {}


def run_predict(case, g, spec, models):
    if case["kind"] == "salted":
        # the stand-in tokenizer's own per-process salted hash
        encoder.__dict__.pop("hash", None)
    else:
        encoder.hash = lambda w: zlib.crc32(w.encode())
    llama = LlamaModel(LlamaConfig(**spec["llama"])).eval()
    llama.load_state_dict(models["llama"])
    clip = CLIPTextModel(CLIPTextConfig(**spec["clip"])).eval()
    clip.load_state_dict(models["clip"])
    vae = AutoencoderKLCausal3D(VAEConfig(**_cfg(spec["vae"]))).eval()
    vae.load_state_dict(models["vae"])
    tpl = spec["template"]
    args = InferenceArgs(text_states_dim=64, text_states_dim_2=48,
                         vae_tiling=False, device="cpu",
                         mesh_shape=f"dp:{case['dp']},ulysses:{case['u']},"
                                    f"ring:{case['r']}")
    sampler = HunyuanVideoSampler(
        args, vae, TextEncoder("llm", 16, llama, prompt_template=tpl,
                               prompt_template_video=tpl,
                               hidden_state_skip_layer=1),
        TextEncoder("clipL", 20, clip), build_dit(spec, models, "dit_pipe"))
    assert sampler.sp_groups.pcfg == g.pcfg
    if case["kind"] == "predict":
        return {"samples": sampler.predict(**case["predict"])["samples"]}
    if case["kind"] == "salted":
        out = {"samples": sampler.predict(**case["predict"])["samples"]}
        if g.rank == 0:   # rank 0 alone, its own text, whole modules
            llama = LlamaModel(LlamaConfig(**spec["llama"])).eval()
            llama.load_state_dict(models["llama"])
            alone = HunyuanVideoSampler(
                args, vae, TextEncoder("llm", 16, llama, prompt_template=tpl,
                                       prompt_template_video=tpl,
                                       hidden_state_skip_layer=1),
                sampler.text_encoder_2, sampler.transformer,
                sp_groups=sampler.sp_groups, memory_tiers=False)
            alone.pipeline.sp = None
            out["single"] = alone.predict(**case["predict"])["samples"]
        return out
    # lockstep serving: rank 0 takes the request, the others follow it
    if g.rank:
        serve.follow(sampler)
        return {}
    p = case["predict"]
    body = {"prompt": p["prompt"], "height": p["height"],
            "width": p["width"], "video_length": p["video_length"],
            "seed": p["seed"], "infer_steps": p["infer_steps"],
            "guidance_scale": p["guidance_scale"],
            "flow_shift": p["flow_shift"],
            "num_videos": p["num_videos_per_prompt"]}
    out = serve.run_predict(sampler, serve.request_kwargs(body))
    serve._broadcast(None, sampler)
    return {"samples": out["samples"]}


def run_train(case, g, inp, spec, models):
    """Two steps of the sharded SGD (or AdamW + EMA) step on the global
    batch; the world-mean losses, and rank 0's parameters. Every rank
    reports whether its parameters equal rank 0's bit for bit."""
    model = build_dit(spec, models, f"train_{case['model']}")
    data = "tsta" if case["model"] == "sta" else "tdense"
    data = [torch.from_numpy(inp[f"{data}_{n}"]) for n in (
        "x0", "noise", "t", "pe", "mask", "pe2", "cos", "sin")]
    if case.get("optimizer") == "adamw":
        step, init = make_train_step_adamw(model, sp=g, **case["opt"])
        state = init()
        losses = [step(state, *data)[1] for _ in range(case["steps"])]
    else:
        step = make_train_step(model, sp=g, **case["opt"])
        losses = [step(*data) for _ in range(case["steps"])]
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    out = {"losses": torch.stack(losses),
           "equal_to_rank0": torch.tensor(float(torch.equal(flat, ref)))}
    if g.rank == 0:
        out.update({f"param/{n}": p.detach()
                    for n, p in model.named_parameters()})
    return out


def run_adjoint(case, g):
    """<f(x), y> against <x, f^T(y)> (the backward) for each collective,
    each summed over the ranks; x and y drawn per rank from a seed."""
    gen = torch.Generator().manual_seed(100 + g.rank)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    b, s, h, d = 2, 6, 4, 3
    fns = {
        "ulysses_scatter": (lambda x: [spa.ulysses_scatter(x[0], g)],
                            [(b, s, h, d)]),
        "ulysses_unscatter": (lambda x: [spa.ulysses_unscatter(x[0], g)],
                              [(b, s * g.u, h // g.u * d)]),
        "ulysses_gather_heads": (
            lambda x: [spa.ulysses_gather_heads(x[0], g)], [(b, s, 5)]),
        "ring_send_recv": (lambda x: spa.ring_send_recv(
            [(x[0], 1), (x[1], -1), (x[2], 1)], g),
            [(b, s, 5), (b, 3, 2), (b, 4)]),
        "gather_ring": (lambda x: spa._gather_ring(x[0], g), [(b, s, 5)]),
    }
    out = {}
    for name, (fn, shapes) in fns.items():
        if (name.startswith("ulysses") and g.u == 1) or (
                not name.startswith("ulysses") and g.r == 1):
            continue
        xs = [rnd(*sh).requires_grad_(True) for sh in shapes]
        with torch.enable_grad():
            ys = fn(xs)
            ws = [rnd(*y.shape) for y in ys]
            lhs = sum((y * w).sum() for y, w in zip(ys, ws))
            grads = torch.autograd.grad(lhs, xs)
        rhs = sum((x * gx).sum() for x, gx in zip(xs, grads))
        both = torch.stack([lhs.detach(), rhs.detach()])
        dist.all_reduce(both)
        out[name] = both
    return out


def run_batch_slice(case, g):
    """The rows of a global batch that `local_batch_slice` (a slice by
    global rank) and the loader's `SPGroups.batch_range` (by dp index)
    give this rank."""
    n = case["batch"]
    return {name: torch.tensor([sl.start, sl.stop]) for name, sl in (
        ("local_batch_slice", local_batch_slice(n)),
        ("batch_range", g.batch_range(n)))}


def run_cli(case, g, case_dir):
    """train.main under this world: two steps and a checkpoint, then a
    resume for a third; rank k writes to out_r{k} (only rank 0 may write),
    every rank resumes from rank 0's checkpoint."""
    base = os.path.join(case_dir, case["name"])
    common = ["--data-dir", os.path.join(case_dir, "cli_data"),
              "--output-dir", os.path.join(base, f"out_r{g.rank}"),
              *case["argv"]]
    losses = train_cli.main(common + ["--steps", "2"])
    ck = os.path.join(base, "out_r0", "step_0000002")
    more = train_cli.main(common + ["--steps", "3", "--resume", ck])
    return {"losses": torch.tensor(losses + more)}


def main():
    case_dir, world, rank, port = sys.argv[1], *map(int, sys.argv[2:])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    with open(os.path.join(case_dir, "spec.json")) as f:
        spec = json.load(f)
    inp = dict(np.load(os.path.join(case_dir, "inputs.npz")))
    models = torch.load(os.path.join(case_dir, "models.pt"),
                        weights_only=True)
    outs = {}
    with torch.no_grad():
        for case in spec["cases"]:
            if case["world"] != world:
                continue
            g = make_groups(ParallelConfig(case["dp"], case["u"], case["r"]))
            kind = case["kind"]
            if kind == "attn":
                res = run_attn(case, g, inp)
            elif kind == "train":
                res = run_train(case, g, inp, spec, models)
            elif kind == "adjoint":
                res = run_adjoint(case, g)
            elif kind == "cli":
                res = run_cli(case, g, case_dir)
            elif kind == "batch_slice":
                res = run_batch_slice(case, g)
            elif kind == "dit":
                res = run_dit(case, g, inp, spec, models)
            elif kind == "denoise":
                res = run_denoise(case, g, inp, spec, models)
            elif kind == "wshard":
                res = run_wshard(case, g, inp, spec, models)
            elif kind == "tp":
                res = run_tp(case, g, inp, spec, models)
            elif kind == "tiles":
                res = run_tiles(case, g, inp, spec, models)
            elif kind == "tiers":
                res = run_tiers(case, g, spec, models)
            elif kind == "infer":
                res = run_infer(case, g, case_dir)
            else:
                res = run_predict(case, g, spec, models)
            for k, v in res.items():
                outs[f"{case['name']}/{k}"] = (
                    v.numpy() if v.dtype == torch.float64
                    else v.float().numpy())
    np.savez(os.path.join(case_dir, f"out_w{world}_r{rank}.npz"), **outs)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
