"""Where the time goes on the PyTorch port's main path, on one NVIDIA GPU.

    python3 scripts/torch_profile.py [--steps 2]
    python3 scripts/torch_profile.py --attn-mode sta --sta-dense-blocks 1 \
        --height 544 --width 960 --frames 65 [--sta-ring]
    python3 scripts/torch_profile.py --use-int8 --attn-mode flash_int8 \
        --text-encoder-quant int8

    python3 scripts/torch_profile.py --train [--train-blocks 20 40]
    python3 scripts/torch_profile.py --train --adamw --train-blocks 4 8

    python3 scripts/torch_profile.py --harness [--config-json exp_1.json]

Builds the sampler as chip_smoke.py's main paths do (HYVideo-T/2 at full
width, Llama-3-8B + CLIP-L, the 884-16c-hy VAE, random weights; by default
dense bf16 attention at 256x448, 33 frames; the weight tiers and int8
attention modes by the CLI's flags; --sta-ring switches the STA blocks to
the ring kernel with sta.set_sta_ring(True); CFG 6.0) and splits predict() into
its three stages: text
encoding, the denoise loop, the tiled VAE decode. Each stage runs once to
warm up, once on the host clock (synchronized) and once under
torch.profiler. Per stage it prints one line: wall seconds, the device's
kernel seconds and busy share (kernel time over wall time; one stream, so
kernels do not overlap), and kernel time by category; then the stage's
top kernels by device time; the full tables go to --out (build/profile/).
With --train it profiles one train step instead (chip_smoke.py's train
path: a trainable bf16 DiT at full width, every block checkpointed, batch 1
at 256x448x33f latents; SGD, or AdamW + master + EMA with --adamw), as one
stage whose categories split the attention kernels (K1, B5f, B5q, B5kv);
a stage of the loss and backward pass alone comes first, so the step's time
less that stage's is the optimizer's (its kernels are elementwise, "other").
With --harness it profiles one video of chip_smoke.py's harness path
instead (the full-width 884-16c-hy VAE in fp16 with random weights as
`infer --random-init` builds it, a t-ops config or none, one smooth
240x432x33 video): the encode, the decode of the posterior's mode, and the
metrics of the pair on the card (PSNR, SSIM, random-weight LPIPS on the
uint8 frames compute_metrics_dir scores), as three stages.
Needs CUDA.
"""
import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import (FRAMES, HEIGHT, TRAIN_LATENT,  # noqa: E402
                        TRAIN_LR, WIDTH, randomize_modulation, train_setup)
from hunyuanvideo_efficiency_tpu_torch.config import InferenceArgs  # noqa: E402
from hunyuanvideo_efficiency_tpu_torch.inference import (  # noqa: E402
    HunyuanVideoSampler, get_rotary_pos_embed)
from hunyuanvideo_efficiency_tpu_torch.ops import sta  # noqa: E402


# the LSE instantiation of csrc/flash_attention.cu's forward template:
# flash_fwd_kernel<T, D, RUNNING=true, LSE=true>
LSE_FORWARD = re.compile(
    r"flash_fwd_kernel<[^>]*(true|\(bool\)1), (true|\(bool\)1)>")
# the RING instantiation of csrc/sta_direct.cu's kernel template:
# sta_direct_kernel<T, D, QUANT, RING=true>
RING_STA = re.compile(r"sta_direct_kernel<[^>]*, (true|\(bool\)1)>")


def category(name: str) -> str:
    low = name.lower()
    if LSE_FORWARD.search(low):
        return "flash forward with LSE (B5f)"
    if "flash_bwd_dq_kernel" in low:
        return "flash backward dQ (B5q)"
    if "flash_bwd_dkv_kernel" in low:
        return "flash backward dK/dV (B5kv)"
    if "flash_fwd_kernel" in low or "flash_combine_kernel" in low:
        return "flash attention (K1/K2)"   # with its key-range split merge
    if "flash_int8_kernel" in low or "quantize_groups_kernel" in low:
        return "int8 flash attention (B8a/B8b)"
    if "w8a8" in low or "quant_rows_kernel" in low:
        return "W8A8 linear (B9)"
    if RING_STA.search(low):
        return "STA ring (B10)"
    if any(k in low for k in ("sta_direct_kernel", "tile_codes_kernel",
                              "sta_permuted_kernel")):
        return "sliding-tile attention (STA)"   # B4/B4q, B6/B6q/B7 and the
                                                # int8 pre-passes
    if "conv3d_s1_kernel" in low:
        return "conv3d (K3)"
    if "conv3d_v2_kernel" in low:
        return "conv3d v2 (B11)"
    if "cudnn" in low or "fprop" in low:
        return "other conv (cuDNN)"
    if any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "GEMM (cuBLAS)"
    return "other (elementwise, norms, copies, reductions)"


def stage(label, fn, out_dir, top=12):
    fn()                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.self_device_time_total / 1e6, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    if not kernels:
        raise RuntimeError(f"{label}: the profiler recorded no device time")
    device = sum(s for _, s, _ in kernels)
    by_cat = {}
    for name, s, _ in kernels:
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + s
    by_cat = dict(sorted(by_cat.items(), key=lambda kv: -kv[1]))
    print(f"[stage] {label} wall_s={wall} device_s={device} "
          f"busy_share={device / wall} by_category_s={json.dumps(by_cat)}",
          flush=True)
    lines = [f"{s:12.6f} s {n:7d}x  {name[:150]}" for name, s, n in kernels]
    for line in lines[:top]:
        print("   ", line)
    (out_dir / f"{label}.txt").write_text("\n".join(lines) + "\n")


def train_stage(a, out_dir):
    """One train step of chip_smoke.py's train path under the profiler."""
    from hunyuanvideo_efficiency_tpu_torch.models.dit import patchify_raw
    from hunyuanvideo_efficiency_tpu_torch.training import (
        flow_match_loss, make_train_step, make_train_step_adamw)

    dev = torch.device("cuda")
    model, batch, _ = train_setup(
        dev, TRAIN_LATENT, 20, mm_double_blocks_depth=a.train_blocks[0],
        mm_single_blocks_depth=a.train_blocks[1])
    if a.adamw:
        step_fn, init_fn = make_train_step_adamw(
            model, lr=1e-4, weight_decay=1e-4, grad_clip=1.0, ema_decay=0.99)
        state = init_fn()

        def step():
            step_fn(state, *batch)
    else:
        sgd = make_train_step(model, lr=TRAIN_LR)

        def step():
            sgd(*batch)

    def loss_backward():
        x0, noise, t, pe, mask, pe2, cos_g, sin_g = batch
        d = cos_g.shape[-1]
        for p in model.parameters():
            p.grad = None
        with torch.enable_grad():
            flow_match_loss(
                model, patchify_raw(x0, model.cfg.patch_size),
                patchify_raw(noise, model.cfg.patch_size), t, pe, mask, pe2,
                cos_g.reshape(-1, d), sin_g.reshape(-1, d), None).backward()

    label = (f"{'adamw' if a.adamw else 'sgd'}_"
             f"{a.train_blocks[0]}+{a.train_blocks[1]}_blocks")
    torch.cuda.reset_peak_memory_stats()
    # the step minus its loss + backward part is the optimizer's share
    stage(f"train_loss_backward_{label}", loss_backward, out_dir, top=4)
    stage(f"train_step_{label}", step, out_dir, top=16)
    print(f"[train] params={sum(p.numel() for p in model.parameters())} "
          f"max_memory_allocated_gb="
          f"{torch.cuda.max_memory_allocated() / 2**30}", flush=True)


def harness_stages(a, out_dir):
    """One video's round trip and metrics on chip_smoke.py's harness
    path, stage by stage."""
    from chip_smoke import harness_video
    from hunyuanvideo_efficiency_tpu_torch import infer
    from hunyuanvideo_efficiency_tpu_torch.evaluation import (
        lpips_video, psnr_video, random_lpips_params, ssim_video)

    dev = torch.device("cuda")
    vae = infer.load_vae("884-16c-hy", "fp16", str(out_dir / "no_vae"),
                         a.config_json, test=True, random_init=True,
                         device=dev)[0]
    x = harness_video(torch.Generator(dev).manual_seed(70))[None]
    lpips_model = random_lpips_params(torch.Generator(dev).manual_seed(72))
    held = {}

    def frames(v):   # [1, C, T, H, W] in [-1, 1] -> [T, H, W, C] uint8
        v = v[0].float().permute(1, 2, 3, 0)
        return ((v + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)

    def encode():
        held["z"] = vae.encode(x).mode().movedim(-1, 1)

    def decode():
        held["rec"] = vae.decode(held["z"])

    def metrics():   # cropped to the common frames, as compute_pair does
        a8, b8 = frames(x), frames(held["rec"])
        a8, b8 = a8[:len(b8)], b8[:len(a8)]
        psnr_video(a8, b8), ssim_video(a8, b8)
        lpips_video(lpips_model, a8, b8)

    torch.cuda.reset_peak_memory_stats()
    for label, fn in (("encode", encode), ("decode", decode),
                      ("metrics", metrics)):
        stage(f"harness_{label}", fn, out_dir)
    print(f"[harness] config={a.config_json} latent={list(held['z'].shape)} "
          f"recon={list(held['rec'].shape)} max_memory_allocated_gb="
          f"{torch.cuda.max_memory_allocated() / 2**30}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train", action="store_true",
                    help="profile one train step instead of predict()")
    ap.add_argument("--adamw", action="store_true",
                    help="with --train: AdamW + fp32 master + EMA")
    ap.add_argument("--train-blocks", type=int, nargs=2, default=(20, 40),
                    metavar=("DOUBLE", "SINGLE"))
    ap.add_argument("--harness", action="store_true",
                    help="profile one video of the t-ops harness instead")
    ap.add_argument("--config-json", default=None,
                    help="with --harness: the t-ops config (default none)")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--attn-mode", default="auto",
                    choices=["auto", "sta", "flash_int8", "sta_int8"])
    ap.add_argument("--sta-dense-blocks", type=int, default=0)
    ap.add_argument("--sta-ring", action="store_true",
                    help="the STA blocks through the ring kernel (B10)")
    ap.add_argument("--use-fp8", action="store_true")
    ap.add_argument("--use-int8", action="store_true")
    ap.add_argument("--use-int4-modulation", action="store_true")
    ap.add_argument("--text-encoder-quant", choices=["int8"], default=None)
    ap.add_argument("--height", type=int, default=HEIGHT)
    ap.add_argument("--width", type=int, default=WIDTH)
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile.py needs a CUDA device")
    out_dir = Path(a.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if a.train or a.harness:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(f"[env] card={smi} torch={torch.__version__} train={a.train} "
              f"adamw={a.adamw} blocks={list(a.train_blocks)} "
              f"harness={a.harness}", flush=True)
        if a.train:
            train_stage(a, out_dir)
        else:
            harness_stages(a, out_dir)
        return

    args = InferenceArgs(model="HYVideo-T/2", vae_tiling=True,
                         model_base="ckpts-not-present",
                         attn_mode=a.attn_mode,
                         sta_dense_blocks=a.sta_dense_blocks,
                         use_fp8=a.use_fp8, use_int8=a.use_int8,
                         use_int4_modulation=a.use_int4_modulation,
                         text_encoder_quant=a.text_encoder_quant)
    sampler = HunyuanVideoSampler.from_pretrained(args=args,
                                                  allow_random_init=True)
    randomize_modulation(sampler.transformer, 3)
    sta.set_sta_ring(a.sta_ring)
    pipe, dev = sampler.pipeline, sampler.device
    prompt = "A cat walks on the grass, realistic style."
    cos, sin, (tt, th, tw) = get_rotary_pos_embed(
        sampler.transformer.cfg, args.vae, a.frames, a.height, a.width,
        device=dev)
    emb = {}

    def text():
        emb["pe"], emb["mask"], emb["pe2"] = pipe.encode_prompt(
            prompt, sampler.default_negative_prompt, True)

    def denoise():
        emb["latents"] = pipe(
            height=a.height, width=a.width, video_length=a.frames,
            num_inference_steps=a.steps, guidance_scale=6.0,
            generator=torch.Generator(dev).manual_seed(42),
            prompt_embeds=emb["pe"], prompt_mask=emb["mask"],
            prompt_embeds_2=emb["pe2"], freqs_cis=(cos, sin),
            n_tokens=tt * th * tw, output_type="latent").videos

    def decode():
        vcfg = sampler.vae.cfg
        z = emb["latents"] / vcfg.scaling_factor
        if vcfg.shift_factor:
            z = z + vcfg.shift_factor
        sampler.vae.enable_tiling(args.vae_tiling)
        sampler.vae.decode(z)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[env] card={smi} torch={torch.__version__} steps={a.steps} "
          f"size={a.height}x{a.width}x{a.frames} attn_mode={a.attn_mode} "
          f"sta_dense_blocks={a.sta_dense_blocks} sta_ring={a.sta_ring} "
          f"use_fp8={a.use_fp8} "
          f"use_int8={a.use_int8} "
          f"use_int4_modulation={a.use_int4_modulation} "
          f"text_encoder_quant={a.text_encoder_quant}", flush=True)
    stage("text_encode", text, out_dir)
    stage(f"denoise_{a.steps}_steps", denoise, out_dir)
    stage("vae_decode", decode, out_dir)


if __name__ == "__main__":
    main()
