"""Fine-tune the MM-DiT with flow matching on a .pt video/latent dataset, on
one GPU (JAX counterpart: the root train.py).

    python -m hunyuanvideo_efficiency_tpu_torch.train --data-dir DIR \
        --latents --steps 1000 --output-dir train_outputs

The reference stack is inference-only but ships training checkpoints with
dual `module`/`ema` weight sets (reference: hyvideo/inference.py:279-354);
this CLI produces those: an AdamW flow-matching loop with a global-norm
clip, an fp32 master copy of bf16 parameters, EMA tracking, checkpoints and
resume.

Memory on one card. The default `--optimizer adamw` keeps, beside the bf16
weights and gradients, an fp32 master, two fp32 moments and an fp32 EMA:
about 20 bytes a parameter, so the 12.8 B-parameter HYVideo-T/2 at full
depth (about 256 GB) does NOT fit one 80 GB card; on one card AdamW runs at
a depth cut with `--blocks DOUBLE SINGLE` (4 8 is about 2.8 B parameters).
`--optimizer sgd` keeps only the bf16 weights and gradients (4 bytes a
parameter): the full depth fits one 80 GB card (about 48 GiB at 256x448x33f
latents, batch 1). Its checkpoints hold `module` and `meta.json` only.

Data: a directory of `.pt` tensors, either pixel videos `[C, T, H, W]` in
[-1, 1] (encoded through the VAE per batch) or precomputed latents
`[16, T', H', W']` with `--latents`.

Text conditioning comes from precomputed embeddings (`--text-embeds`: a
`.pt` dict with pe [1, L, 4096], mask [1, L], pe2 [1, 768]) or a fixed
random stand-in: the text towers are frozen in fine-tuning, so
embedding once is both faster and exact.

Checkpoints: `<output-dir>/step_%07d/{module, ema, opt_state, master,
meta.json}`; `module` and `ema` are plain state dicts with the reference's
key names (`--dit-weight <dir>/module` of the sampler loads them).

Example (smoke, CPU):
    python -m hunyuanvideo_efficiency_tpu_torch.train --toy --steps 3 \
        --data-dir /path/to/latents --latents --device cpu --output-dir run
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data-dir", required=True,
                   help=".pt tensor dir (videos, or latents with --latents)")
    p.add_argument("--latents", action="store_true",
                   help="data are VAE latents [16, T', H', W'] already")
    p.add_argument("--output-dir", default="train_outputs")
    p.add_argument("--model", default="HYVideo-T/2-cfgdistill")
    p.add_argument("--dit-weights", default=None,
                   help=".pt DiT state dict (default: random init)")
    p.add_argument("--vae-weights", default=None,
                   help=".pt VAE state dict (default: random; unused with "
                        "--latents)")
    p.add_argument("--text-embeds", default=None,
                   help=".pt dict with pe [1,L,4096], mask [1,L], "
                        "pe2 [1,768]")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--optimizer", choices=("adamw", "sgd"), default="adamw",
                   help="adamw: fp32 master + moments + EMA, about 20 bytes "
                        "a parameter; sgd: bf16 weights and gradients only "
                        "(the full-depth model on one 80 GB card)")
    p.add_argument("--blocks", type=int, nargs=2, default=None,
                   metavar=("DOUBLE", "SINGLE"),
                   help="cut the DiT's depth to this many double and single "
                        "blocks at the model's width (default: the model's)")
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--ema-decay", type=float, default=0.9999)
    p.add_argument("--no-ema", action="store_true")
    p.add_argument("--mesh-shape", default=None,
                   help="only dp:1,ulysses:1,ring:1 (sequence-parallel "
                        "training is not ported)")
    p.add_argument("--save-every", type=int, default=500)
    p.add_argument("--resume", default=None,
                   help="checkpoint dir from a previous run")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--attn-mode", default="auto")
    p.add_argument("--toy", action="store_true",
                   help="tiny architecture (CI / smoke testing)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def check_mesh_shape(spec) -> None:
    """Only the one-device mesh is ported."""
    if not spec:
        return
    for part in spec.split(","):
        name, degree = part.split(":")
        if int(degree) != 1:
            raise NotImplementedError(
                f"--mesh-shape {spec!r}: {name.strip()} degree {degree} is "
                f"not ported (sequence- and data-parallel training run only "
                f"in the JAX package)")


def build_cfg(args):
    from dataclasses import replace

    from .models.dit_config import DiTConfig, load_dit_config

    if args.toy:
        cfg = DiTConfig(
            hidden_size=128, heads_num=4, mm_double_blocks_depth=2,
            mm_single_blocks_depth=2, rope_dim_list=(8, 12, 12),
            text_states_dim=64, text_states_dim_2=32, guidance_embed=True,
            attn_mode="sdpa")
    else:
        cfg = load_dit_config(args.model, attn_mode=args.attn_mode)
    if args.blocks is not None:
        cfg = replace(cfg, mm_double_blocks_depth=args.blocks[0],
                      mm_single_blocks_depth=args.blocks[1])
    return cfg


def load_batch(dataset, idxs, args, vae, device):
    """Stack a batch of fp32 latents [B, 16, T', H', W'] from the dataset."""
    x = torch.stack([dataset[int(i) % len(dataset)][0] for i in idxs])
    x = x.to(device)
    if args.latents:
        return x
    with torch.no_grad():
        z = vae.encode(x.to(vae.dtype)).mode()
    return (z * vae.cfg.scaling_factor).float()


def load_text_embeds(path, device):
    te = torch.load(path, map_location="cpu", weights_only=True)
    return (te["pe"].float().to(device), te["mask"].to(device),
            te["pe2"].float().to(device))


def main(argv=None):
    args = parse_args(argv)
    check_mesh_shape(args.mesh_shape)

    from .data.dataset_loader import VideoTensorDataset
    from .models.dit import build_dit
    from .ops.rope import get_nd_rotary_pos_embed
    from .training import make_train_step, make_train_step_adamw
    from .utils.checkpoint import load_torch_state_dict
    from .utils.train_io import load_tree, save_tree

    device = torch.device(args.device)
    cfg = build_cfg(args)
    # one explicit generator drives the loop's draws (batch, noise, t); it
    # lives on the CPU so the stream does not depend on the device
    gen = torch.Generator().manual_seed(args.seed)

    # ---- params ----
    init_gen = (None if args.dit_weights else
                torch.Generator(device=device).manual_seed(args.seed))
    model = build_dit(cfg, device, torch.bfloat16, init_gen, trainable=True)
    if args.dit_weights:
        model.load_state_dict(load_torch_state_dict(args.dit_weights))

    # ---- VAE (only to encode pixel videos) ----
    vae = None
    if not args.latents:
        from .models.vae import build_vae
        from .models.vae_config import VAEConfig

        vae = build_vae(
            VAEConfig(), device, torch.float32,
            None if args.vae_weights else
            torch.Generator(device=device).manual_seed(7))
        if args.vae_weights:
            vae.load_state_dict(load_torch_state_dict(args.vae_weights,
                                                      prefix="vae."))

    dataset = VideoTensorDataset(args.data_dir)
    if len(dataset) == 0:
        raise ValueError(f"no .pt tensors under {args.data_dir}")

    # ---- probe one sample for the latent grid / RoPE ----
    z0 = load_batch(dataset, [0], args, vae, device)
    _, _, t_lat, h_lat, w_lat = z0.shape
    pt, ph, pw = cfg.patch_size
    tt, th, tw = t_lat // pt, h_lat // ph, w_lat // pw
    cos, sin = get_nd_rotary_pos_embed(cfg.rope_dim_list, (tt, th, tw),
                                       theta=cfg.rope_theta, device=device)
    d = cos.shape[-1]
    cos_g, sin_g = cos.reshape(tt, th, tw, d), sin.reshape(tt, th, tw, d)

    # ---- text conditioning (frozen towers -> precomputed embeddings) ----
    lt = 16 if args.toy else 256
    if args.text_embeds:
        pe1, mask1, pe21 = load_text_embeds(args.text_embeds, device)
    else:
        tg = torch.Generator().manual_seed(11)
        pe1 = torch.randn(1, lt, cfg.text_states_dim, generator=tg).to(device)
        mask1 = torch.ones(1, lt, dtype=torch.int32, device=device)
        pe21 = torch.randn(1, cfg.text_states_dim_2, generator=tg).to(device)
    b = args.batch_size
    pe, mask, pe2 = pe1.repeat(b, 1, 1), mask1.repeat(b, 1), pe21.repeat(b, 1)

    # ---- optimizer / step ----
    if args.optimizer == "sgd":
        sgd_step = make_train_step(model, lr=args.lr)
        state = {"opt_state": None, "master": None, "ema": None, "step": 0}

        def step_fn(state, *batch):
            loss = sgd_step(*batch)
            state["step"] += 1
            return state, loss
    else:
        step_fn, init_fn = make_train_step_adamw(
            model, lr=args.lr, weight_decay=args.weight_decay,
            grad_clip=args.grad_clip,
            ema_decay=None if args.no_ema else args.ema_decay)
        state = init_fn()
    start = 0
    if args.resume:
        def restore(sub):
            return load_tree(os.path.join(args.resume, sub), device)

        model.load_state_dict(restore("module"))
        if state["opt_state"] is not None:
            state["opt_state"] = restore("opt_state")
        if state["master"] is not None:
            if os.path.exists(os.path.join(args.resume, "master")):
                state["master"] = restore("master")
            else:  # a checkpoint without a master copy: rebuild from module
                state["master"] = {n: p.detach().float().clone()
                                   for n, p in model.named_parameters()}
        if state["ema"] is not None \
                and os.path.exists(os.path.join(args.resume, "ema")):
            state["ema"] = restore("ema")
        with open(os.path.join(args.resume, "meta.json")) as f:
            start = int(json.load(f)["step"])
        state["step"] = start

    os.makedirs(args.output_dir, exist_ok=True)

    def save(step_i):
        ck = os.path.join(args.output_dir, f"step_{step_i:07d}")
        save_tree(os.path.join(ck, "module"), model.state_dict())
        if state["opt_state"] is not None:
            save_tree(os.path.join(ck, "opt_state"), state["opt_state"])
        if state["master"] is not None:
            save_tree(os.path.join(ck, "master"), state["master"])
        if state["ema"] is not None:
            save_tree(os.path.join(ck, "ema"), state["ema"])
        with open(os.path.join(ck, "meta.json"), "w") as f:
            json.dump({"step": step_i, "model": args.model,
                       "toy": args.toy, "optimizer": args.optimizer,
                       "blocks": args.blocks}, f)
        return ck

    # ---- loop ----
    losses = []
    for i in range(start, args.steps):
        idxs = torch.randint(len(dataset), (b,), generator=gen)
        x0 = load_batch(dataset, idxs.tolist(), args, vae, device)
        noise = torch.randn(x0.shape, generator=gen).to(device)
        t = torch.rand(b, generator=gen).to(device)
        t0 = time.time()
        state, loss = step_fn(state, x0, noise, t, pe, mask, pe2, cos_g,
                              sin_g)
        loss = float(loss)
        losses.append(loss)
        print(f"step {i + 1}/{args.steps} loss {loss:.5f} "
              f"({time.time() - t0:.2f}s)", flush=True)
        if (i + 1) % args.save_every == 0 or (i + 1) == args.steps:
            print(f"saved {save(i + 1)}", flush=True)
    return losses


if __name__ == "__main__":
    main()
