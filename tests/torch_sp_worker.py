"""One rank of a gloo world for tests/test_torch_sp.py: runs every case of
its world size through the port's sequence parallelism on the CPU (sampling
and, for the "train", "adjoint" and "cli" cases, training) and writes this
rank's outputs. Imports torch and the port only.

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
from hunyuanvideo_efficiency_tpu_torch.models.vae import (  # noqa
    AutoencoderKLCausal3D)
from hunyuanvideo_efficiency_tpu_torch.models.vae_config import (  # noqa
    VAEConfig)
from hunyuanvideo_efficiency_tpu_torch.ops.attention import (  # noqa
    text_key_bias)
from hunyuanvideo_efficiency_tpu_torch.parallel import (  # noqa
    ParallelConfig, local_batch_slice, make_groups, usp_joint_attention)
from hunyuanvideo_efficiency_tpu_torch.parallel import (  # noqa
    sp_attention as spa)
from hunyuanvideo_efficiency_tpu_torch.training import (  # noqa
    make_train_step, make_train_step_adamw)


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


def run_dit(case, g, inp, spec, models):
    m = case["model"]
    model = build_dit(spec, models, f"dit_{m}")
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


def run_denoise(case, g, inp, spec, models):
    model = build_dit(spec, models, "dit_dense")
    pipe = HunyuanVideoPipeline(None, None, None, model,
                                FlowMatchDiscreteScheduler(), sp=g)
    sigmas, timesteps = get_sigmas(case["steps"], shift=7.0)
    f = [torch.from_numpy(inp[f"den_{n}"]) for n in ("cos", "sin")]
    lat = pipe._denoise_sharded(
        torch.from_numpy(inp["den_x"]), sigmas, timesteps,
        *(torch.from_numpy(inp[f"den_{n}"]) for n in ("txt", "mask", "txt2")),
        f, True, case["guidance_scale"], None, case["guidance_rescale"])
    return {"latents": lat}


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
        if g.rank == 0:   # rank 0 alone, its own text
            sampler.pipeline.sp = None
            out["single"] = sampler.predict(**case["predict"])["samples"]
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
