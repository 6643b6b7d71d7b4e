"""Driver of the text-to-video cells: one client, one `predict()` at a time.

Set-up builds the program's sampler (`HunyuanVideoSampler`) from its public
modules and loads the weights the benchmark draws from the seed
(benchmark/weights.py), then warms the cell's shapes with one denoise step
of the same call. The window is one `predict()` of a seeded prompt: each
step's end is synchronized in `progress_callback`, and the call is stopped
after the step in flight when `--seconds` is up (the decode is never
reached). Afterwards the program is freed and the plain reference
(benchmark/reference/) recomputes, from the same weights and inputs, the
guided velocity of one of the window's steps, drawn from the seed among
the first CHECK_STEPS (the window's last where it holds fewer): the text
towers from the prompt, the DiT and the Euler step, from the program's
latent before that step (from the seeded noise for the first). The
program's velocity is read off its latents, (x_{i+1} - x_i) /
(sigma_{i+1} - sigma_i).
"""
from __future__ import annotations

import gc
import random
import time
from typing import Dict, List

import torch

from .. import weights
from ..reference import dit as ref_dit
from ..reference import text as ref_text
from ..traffic import prompt

# groups whose leaves carry the model's full key names; every other group
# tag is the path of the module its leaves belong to
ROOT_TAGS = {"embed", "norm", "final_layer_norm", "encoder", "decoder",
             "lpips"}
DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16,
          "fp32": torch.float32}


CHECK_STEPS = 4


class StopWindow(Exception):
    """Raised from the step callback when the window has closed."""


def load_weights(root: torch.nn.Module, model: str, cfg: dict, seed: int,
                 device, dtype) -> None:
    """Load every group of `model` into the program's module `root`; every
    key of the module is loaded exactly once, or this raises."""
    seen = set()
    for tag, sd in weights.state_dicts(model, cfg, seed, device, dtype):
        mod = root if tag in ROOT_TAGS else root.get_submodule(tag)
        _, unexpected = mod.load_state_dict(sd, strict=False)
        if unexpected:
            raise KeyError(f"{model}.{tag}: the program has no {unexpected}")
        prefix = "" if tag in ROOT_TAGS else f"{tag}."
        seen |= {prefix + k for k in sd}
    missing = set(root.state_dict()) - seen
    if missing:
        raise KeyError(f"{model}: no weights drawn for {sorted(missing)[:5]}")


# the configuration file's keys: those the program is built from, the
# weight tiers passed to it, and those that only describe the file; any
# other key raises, so that no setting is silently left out
TIER_FLAGS = ("use_fp8", "use_int8", "use_int4_modulation")
CONFIG_KEYS = {"name", "source", "model", "dit", "precision", "attn_mode",
               "sta", "text", "vae", "control", "reduced", "assumed",
               "cuts", *TIER_FLAGS}
TEXT_KEYS = {"llm", "clip", "precision", "text_len", "text_len_2",
             "prompt_template_video", "crop_start",
             "hidden_state_skip_layer"}
STA_KEYS = {"tile", "window", "dense_double_blocks", "dense_single_blocks"}


def check_keys(cfg: dict) -> None:
    for where, got, known in (("", cfg, CONFIG_KEYS),
                              ("text.", cfg["text"], TEXT_KEYS),
                              ("sta.", cfg["sta"] or {}, STA_KEYS)):
        unknown = sorted(set(got) - known)
        if unknown:
            raise KeyError(f"configuration {cfg['name']}: the t2v driver "
                           f"passes no {[where + k for k in unknown]} to "
                           f"the program")


def build_sampler(cfg: dict, seed: int, device):
    """The program's sampler with the benchmark's weights."""
    from hunyuanvideo_efficiency_tpu_torch.config import InferenceArgs
    from hunyuanvideo_efficiency_tpu_torch.constants import PROMPT_TEMPLATE
    from hunyuanvideo_efficiency_tpu_torch.inference import (
        HunyuanVideoSampler)
    from hunyuanvideo_efficiency_tpu_torch.models.dit import build_dit
    from hunyuanvideo_efficiency_tpu_torch.models.dit_config import (
        load_dit_config)
    from hunyuanvideo_efficiency_tpu_torch.models.text import (
        CLIPTextConfig, LlamaConfig, build_text_encoders)
    from hunyuanvideo_efficiency_tpu_torch.models.vae import build_vae
    from hunyuanvideo_efficiency_tpu_torch.models.vae_config import (
        VAEConfig)
    from hunyuanvideo_efficiency_tpu_torch.ops.quantization import (
        quantize_dit)

    check_keys(cfg)
    tiers = {k: bool(cfg.get(k, False)) for k in TIER_FLAGS}
    dit = {k: tuple(v) if isinstance(v, list) else v
           for k, v in cfg["dit"].items() if k != "refiner_depth"}
    sta = cfg["sta"] or {}
    dense = sta.get("dense_double_blocks", 0)
    dit_cfg = load_dit_config(
        cfg["model"], attn_mode=cfg["attn_mode"],
        sta_tile=tuple(sta.get("tile", (4, 8, 8))),
        sta_window=tuple(sta.get("window", (3, 3, 3))),
        sta_dense_double_blocks=dense,
        sta_dense_single_blocks=sta.get("dense_single_blocks", 0), **dit)
    dtype = DTYPES[cfg["precision"]]
    transformer = build_dit(dit_cfg, device, dtype)
    load_weights(transformer, "dit", cfg["dit"], seed, device, dtype)
    quantize_dit(transformer, fp8=tiers["use_fp8"], int8=tiers["use_int8"],
                 int4_modulation=tiers["use_int4_modulation"])

    text = cfg["text"]
    crop = PROMPT_TEMPLATE[text["prompt_template_video"]]["crop_start"]
    if crop != text["crop_start"]:
        raise ValueError(f"configuration {cfg['name']}: crop_start "
                         f"{text['crop_start']}, the program's template "
                         f"{text['prompt_template_video']} crops {crop}")
    tdtype = DTYPES[text["precision"]]
    llm_cfg = LlamaConfig(**text["llm"])
    clip_cfg = CLIPTextConfig(**text["clip"])
    te, te2 = build_text_encoders(
        llm_config=llm_cfg, clip_config=clip_cfg, text_len=text["text_len"],
        text_len_2=text["text_len_2"],
        hidden_state_skip_layer=text["hidden_state_skip_layer"],
        prompt_template_video=text["prompt_template_video"],
        device=device, dtype=tdtype)
    load_weights(te.model, "llm", text["llm"], seed, device, tdtype)
    load_weights(te2.model, "clip", text["clip"], seed, device, tdtype)

    v = cfg["vae"]
    vae = build_vae(VAEConfig(
        **{k: tuple(x) if isinstance(x, list) else x for k, x in v.items()
           if k not in ("name", "precision")}), device, DTYPES[v["precision"]])
    load_weights(vae, "vae", v, seed, device, DTYPES[v["precision"]])

    args = InferenceArgs(model=cfg["model"], precision=cfg["precision"],
                         vae=v["name"], vae_precision=v["precision"],
                         text_encoder_precision=text["precision"],
                         attn_mode=cfg["attn_mode"],
                         sta_dense_blocks=dense,
                         prompt_template_video=text["prompt_template_video"],
                         **tiers,
                         device=str(device))
    return HunyuanVideoSampler(args, vae, te, te2, transformer)


def predict_steps(sampler, traffic: dict, text: str, video_seed: int,
                  on_step) -> None:
    """One predict() of the cell's traffic; `on_step(i, latents)` after each
    step may raise StopWindow to end it."""
    try:
        sampler.predict(text, height=traffic["height"],
                        width=traffic["width"],
                        video_length=traffic["video_length"],
                        seed=video_seed, infer_steps=traffic["infer_steps"],
                        guidance_scale=traffic["guidance_scale"],
                        flow_shift=traffic["flow_shift"],
                        progress_callback=on_step)
    except StopWindow:
        return
    raise RuntimeError("the video finished inside the window: the window "
                       "must end before the last step")


def inputs(traffic: dict, seed: int):
    """(prompt, the video's seed) drawn from the run's seed."""
    words = prompt(weights.group_seed(seed, "prompt"),
                   traffic["prompt_words"], traffic["word_letters"])
    return words, weights.group_seed(seed, "noise") % (2 ** 62)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> None:
    """Set-up, warm-up, the window and the check of one t2v run; fills
    `ctx` (benchmark/run.py's Run)."""
    cfg, traffic, seed, dev = ctx.cfg, ctx.traffic, ctx.seed, ctx.device
    ctx.log("set-up: building the sampler")
    sampler = build_sampler(cfg, seed, dev)
    text, video_seed = inputs(traffic, seed)
    ctx.log("set-up: one warm step")

    def warm(i, lat):
        raise StopWindow

    predict_steps(sampler, traffic, text, video_seed, warm)
    sync(dev)
    ctx.setup_done()

    marks: List[float] = []
    counts: List[Dict[str, int]] = []
    keep: Dict[int, torch.Tensor] = {}
    pick = random.Random(weights.group_seed(seed, "check")).randrange(
        CHECK_STEPS)

    def on_step(i, lat):
        sync(dev)
        marks.append(time.perf_counter())
        counts.append(ctx.read_counts())
        ctx.mark()
        # x_{i+1}; kept: x_pick, x_{pick+1} and the last two
        keep[i + 1] = lat.clone()
        for j in [j for j in keep if j < i and j not in (pick, pick + 1)]:
            del keep[j]
        if marks[-1] - t0 >= ctx.seconds:
            raise StopWindow

    ctx.window_start()
    t0 = time.perf_counter()
    with ctx.recorder():
        predict_steps(sampler, traffic, text, video_seed, on_step)
    steps = len(marks)
    ctx.window_end()
    ctx.e2e["step_s"] = (marks[-1] - t0) / steps
    ctx.attempted, ctx.failed = steps, 0
    ctx.per_layer_span(first_mark=0, last_mark=steps - 1,
                       units=steps - 1,
                       launches={k: counts[-1][k] - counts[0][k]
                                 for k in counts[0]})
    valid = [ref_text.text_valid(p, cfg["text"]) for p in
             (ref_text.NEGATIVE_PROMPT, text)]
    ctx.shapes = dict(traffic=traffic, text_valid=valid, batch=2)

    ctx.log(f"window: {steps} steps")
    lat = {i: x.float() for i, x in keep.items()}
    del sampler, keep
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    check(ctx, text, video_seed, lat, min(pick, steps - 1))


def program_velocity(lat: Dict[int, torch.Tensor], sig, i: int):
    """The program's velocity at step i from its latents lat[i] (x_0 the
    seeded noise, x_{i+1} after step i)."""
    return (lat[i + 1] - lat[i]) / float(sig[i + 1] - sig[i])


def noise(cfg: dict, traffic: dict, video_seed: int, device) -> torch.Tensor:
    """The video's initial latent, drawn as the published pipeline draws
    it: randn of the latent shape from a generator seeded with the video's
    seed, on the card."""
    v = cfg["vae"]
    shape = (1, cfg["dit"]["in_channels"],
             (traffic["video_length"] - 1) // v["time_compression_ratio"] + 1,
             traffic["height"] // v["spatial_compression_ratio"],
             traffic["width"] // v["spatial_compression_ratio"])
    g = torch.Generator(device=device).manual_seed(video_seed)
    return torch.randn(shape, generator=g, device=device)


def reference_velocities(cfg, traffic, seed, text, x_by_step, control=False):
    """{step: guided velocity} of the plain reference at each (step,
    latent) of x_by_step, in the configuration's tiers or (`control`) its
    control's."""
    dev = next(iter(x_by_step.values())).device
    sig = ref_dit.sigmas(traffic["infer_steps"], traffic["flow_shift"])
    tx = ref_text.encode([ref_text.NEGATIVE_PROMPT, text], cfg["text"], seed,
                         dev)
    steps = sorted(x_by_step)
    attn = torch.float16 if dev.type == "cuda" else torch.float32
    vs = ref_dit.cfg_velocities(cfg, seed, [x_by_step[i] for i in steps],
                                [float(sig[i]) * 1000.0 for i in steps], tx,
                                traffic["guidance_scale"],
                                ref_dit.tiers(cfg, control), attn)
    return dict(zip(steps, vs))


def rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def check(ctx, text, video_seed, lat, step) -> None:
    """v_rel_l2: the program's velocity at `step` against the reference's
    from the same latent."""
    cfg, traffic, seed = ctx.cfg, ctx.traffic, ctx.seed
    sig = ref_dit.sigmas(traffic["infer_steps"], traffic["flow_shift"])
    if step == 0:
        lat[0] = noise(cfg, traffic, video_seed, lat[1].device)
    prog = program_velocity(lat, sig, step)
    with tf32():
        ref = reference_velocities(cfg, traffic, seed, text,
                                   {step: lat[step]})[step]
    ctx.checks["v_rel_l2"] = rel_l2(prog, ref)
    ctx.log(f"check: reference of step {step} done")


class tf32:
    """The reference's products on TF32 (fp32 sums), restored after."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.old
        return False
