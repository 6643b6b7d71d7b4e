"""Model loading and the HunyuanVideoSampler predict API on one GPU (JAX
counterpart: inference.py; reference: hyvideo/inference.py:143-671).

`Inference.from_pretrained` builds the DiT, the VAE and both text towers
from an `InferenceArgs`: DiT and VAE from the reference `.pt` checkpoints
when they exist (module names match their state-dict keys; with --use-fp8
an fp8 checkpoint and its `_map.pt` scales), else random weights with
`allow_random_init=True`, else FileNotFoundError. The towers load as the
JAX package loads them (`load_tower_weights`), and are random where no
weights are found but `text_encoder/` exists or random weights are
allowed. The weight tiers follow
(JAX inference.py:157-164,201-204): fp8, int8 and int4 modulation on the
DiT's block linears, one module at a time on the device, and int8 on the
LLM tower.
`HunyuanVideoSampler.predict` keeps the reference semantics: seeds
(int / list / None -> one torch.Generator per video, :534-566), H/W
aligned to 16 (:584-585), a fresh scheduler with the runtime flow_shift
(:609-614), the RoPE tables (:450-495) and the pipeline call (:645-664),
traced by torch.profiler under `--profile-dir` (JAX inference.py:324-327).

Sequence parallelism (JAX inference.py:105-121): the args' layout
(`--ulysses-degree`, `--ring-degree`, `--mesh-shape`) must span the whole
process group; its subgroups are built when the sampler is, and every rank
runs `predict` in lockstep on the same arguments (the denoise loop
token-sharded).

The scale-out memory tiers (JAX inference.py:187-200). Under a world larger
than 1, by default (`memory_tiers=True`), the Llama tower is
tensor-parallel over the whole world (models/text/llama.py; CLIP-L stays
replicated) and a tiled VAE encode or decode spreads its spatial tiles over
the world (models/vae.py; an untiled one stays replicated); with
`--shard-dit-weights` the DiT's block stacks are weight-sharded over the sp
group (parallel/weight_shard.py). `from_pretrained` builds the tower and a
sharded DiT a layer or a chunk at a time, so neither is ever whole on the
card; a sampler given whole modules cuts them in place.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .config import InferenceArgs, parse_vae_name
from .constants import NEGATIVE_PROMPT, PRECISION_TO_TYPE
from .diffusion.pipeline import HunyuanVideoPipeline
from .diffusion.scheduler import FlowMatchDiscreteScheduler
from .models.dit import build_dit
from .models.dit_config import DiTConfig, load_dit_config
from .models.text import build_text_encoders
from .models.text.llama import shard_llama
from .models.vae import build_vae
from .models.vae_config import load_vae_config
from .ops.quantization import quantize_dit
from .ops.rope import get_nd_rotary_pos_embed
from .parallel.comm import GroupComm
from .parallel.mesh import make_groups, parallel_config
from .parallel.weight_shard import build_sharded_dit, shard_dit
from .utils.checkpoint import (fp8_checkpoint_state_dict, fp8_map_path,
                               load_params_npz, load_torch_state_dict,
                               load_tower_state_dict)
from .utils.profiling import maybe_trace
from .utils.seeded import randomize_modulation
from .utils.weights import clip_state_dict_from_jax, llama_state_dict_from_jax


def align_to(value: int, alignment: int) -> int:
    """Round `value` up to a multiple of `alignment`."""
    return int(((value + alignment - 1) // alignment) * alignment)


def get_rotary_pos_embed(cfg: DiTConfig, vae_name: str, video_length: int,
                         height: int, width: int, device="cuda"):
    """(cos, sin, patch-grid sizes) (reference: hyvideo/inference.py:450-495)."""
    info = parse_vae_name(vae_name)
    pt, ph, pw = cfg.patch_size
    sizes = (info.latent_frames(video_length) // pt,
             height // info.spatial_ratio // ph,
             width // info.spatial_ratio // pw)
    cos, sin = get_nd_rotary_pos_embed(cfg.rope_dim_list, sizes,
                                       theta=cfg.rope_theta, device=device)
    return cos, sin, sizes


# Files of an HF tokenizer; a tower directory without them gets the
# HashTokenizer stand-in.
_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json",
                    "tokenizer.model")


def _tokenizer_dir(d: Path) -> Optional[str]:
    return (str(d) if any((d / f).exists() for f in _TOKENIZER_FILES)
            else None)


def load_tower_weights(base: Path, kind: str) -> Optional[Dict]:
    """A text tower's weights as the port's state dict, or None for random
    ones (JAX inference.py:209-227): the JAX package's converted
    `text_encoder.npz` / `text_encoder_2.npz` next to the HF directories
    first, else an HF state dict in `text_encoder/` / `text_encoder_2/`."""
    npz_name, dir_name, convert = {
        "llm": ("text_encoder.npz", "text_encoder",
                llama_state_dict_from_jax),
        "clipL": ("text_encoder_2.npz", "text_encoder_2",
                  clip_state_dict_from_jax)}[kind]
    if (base / npz_name).exists():
        return convert(load_params_npz(base / npz_name))
    return load_tower_state_dict(base / dir_name, kind)


def _world() -> int:
    return (torch.distributed.get_world_size()
            if torch.distributed.is_initialized() else 1)


def _sp_groups(args: InferenceArgs):
    """The layout's subgroups, or None on one rank (make_groups raises
    unless the layout spans the process group)."""
    pcfg = parallel_config(args)
    return make_groups(pcfg) if max(pcfg.world_size, _world()) > 1 else None


def _shards_dit(args: InferenceArgs, groups) -> bool:
    """--shard-dit-weights with an sp group of more than one rank."""
    return bool(args.shard_dit_weights and groups is not None
                and groups.sp is not None)


class Inference:
    def __init__(self, args: InferenceArgs, vae, text_encoder,
                 text_encoder_2, transformer, logger=None, sp_groups=None,
                 memory_tiers: bool = True):
        """sp_groups: the layout's subgroups when already built (by
        from_pretrained), else built here. memory_tiers=False keeps the
        Llama tower and the VAE replicated under a world larger than 1."""
        self.args = args
        self.vae = vae
        self.text_encoder = text_encoder
        self.text_encoder_2 = text_encoder_2
        self.transformer = transformer
        self.logger = logger
        # where the modules run (under --use-cpu-offload they may rest on
        # the host between calls)
        self.device = self.transformer.img_in.proj.weight.device
        self.sp_groups = sp_groups or _sp_groups(args)
        if _shards_dit(args, self.sp_groups) and \
                transformer.weight_shards is None:
            shard_dit(transformer, GroupComm(self.sp_groups.sp))
        if memory_tiers and _world() > 1:
            comm = GroupComm()
            if text_encoder is not None and text_encoder.model.tp is None:
                shard_llama(text_encoder.model, comm)
            if vae is not None:
                vae.tile_comm = comm

    @staticmethod
    def resolve_dit_weight(args: InferenceArgs) -> Optional[Path]:
        """(reference: inference.py:279-354)."""
        if args.dit_weight:
            return Path(args.dit_weight)
        base = Path(args.model_base) / "hunyuan-video-t2v-720p/transformers"
        for cand in (f"pytorch_model_{args.load_key}.pt",
                     "mp_rank_00_model_states.pt"):
            if (base / cand).exists():
                return base / cand
        return None

    @classmethod
    def from_pretrained(cls, pretrained_model_path: Optional[str] = None,
                        args: Optional[InferenceArgs] = None,
                        allow_random_init: bool = False, logger=None,
                        memory_tiers: bool = True,
                        modulation_seed: Optional[int] = None, **kwargs):
        """kwargs: `llm_config` / `clip_config` for smaller towers.
        memory_tiers: as Inference. modulation_seed: random values for the
        DiT's zero-initialized adaLN and final layers
        (utils/seeded.randomize_modulation), drawn during the build, so that
        a weight-sharded DiT holds the same values as a replicated one."""
        args = args or InferenceArgs()
        if pretrained_model_path is not None:
            args.model_base = str(pretrained_model_path)
        device = torch.device(args.device)
        base = Path(args.model_base)
        groups = _sp_groups(args)
        tiers = memory_tiers and _world() > 1

        cfg = load_dit_config(args.model, rope_theta=float(args.rope_theta),
                              attn_mode=args.attn_mode,
                              sta_window=tuple(args.sta_window),
                              sta_dense_double_blocks=args.sta_dense_blocks,
                              sta_dense_single_blocks=args.sta_dense_blocks)
        dtype = PRECISION_TO_TYPE[args.precision]
        dit_path = cls.resolve_dit_weight(args)
        sd, gen = None, None
        if dit_path is not None and args.use_fp8 \
                and fp8_map_path(dit_path).exists():
            # upcast with its scales; the fp8 tier is applied again below
            sd = fp8_checkpoint_state_dict(dit_path, fp8_map_path(dit_path),
                                           args.load_key)
        elif dit_path is not None:
            sd = load_torch_state_dict(dit_path, args.load_key)
        elif allow_random_init:
            gen = torch.Generator(device=device).manual_seed(0)
        else:
            raise FileNotFoundError(
                f"No DiT checkpoint under {args.model_base}; pass "
                f"--dit-weight or allow_random_init=True")
        tier_flags = dict(fp8=args.use_fp8, int8=args.use_int8,
                          int4_modulation=args.use_int4_modulation)
        if _shards_dit(args, groups):
            transformer = build_sharded_dit(
                cfg, GroupComm(groups.sp), device, dtype, generator=gen,
                state_dict=sd, modulation_seed=modulation_seed,
                **tier_flags)
        else:
            transformer = build_dit(cfg, device, dtype, gen)
            if sd is not None:
                transformer.load_state_dict(sd)
            quantize_dit(transformer, **tier_flags)
            if modulation_seed is not None:
                randomize_modulation(transformer, modulation_seed)
        del sd

        vae_cfg = load_vae_config(args.vae)
        vae_dtype = PRECISION_TO_TYPE[args.vae_precision]
        vae_path = base / "hunyuan-video-t2v-720p/vae/pytorch_model.pt"
        if vae_path.exists():
            vae = build_vae(vae_cfg, device, vae_dtype)
            vae.load_state_dict(load_torch_state_dict(vae_path, prefix="vae."))
        elif allow_random_init:
            vae = build_vae(vae_cfg, device, vae_dtype,
                            torch.Generator(device=device).manual_seed(1))
        else:
            raise FileNotFoundError(f"No VAE checkpoint at {vae_path}")

        llm_dir, clip_dir = base / "text_encoder", base / "text_encoder_2"
        llm_sd, clip_sd = (load_tower_weights(base, kind)
                           for kind in ("llm", "clipL"))
        if not (llm_dir.exists() or llm_sd is not None or allow_random_init):
            raise FileNotFoundError(f"No text encoder under {args.model_base}")
        text_encoder, text_encoder_2 = build_text_encoders(
            llm_config=kwargs.pop("llm_config", None),
            clip_config=kwargs.pop("clip_config", None),
            llm_state_dict=llm_sd, clip_state_dict=clip_sd,
            tokenizer_path=_tokenizer_dir(llm_dir),
            tokenizer_path_2=_tokenizer_dir(clip_dir),
            text_len=args.text_len, text_len_2=args.text_len_2,
            prompt_template=args.prompt_template,
            prompt_template_video=args.prompt_template_video,
            hidden_state_skip_layer=args.hidden_state_skip_layer,
            apply_final_norm=args.apply_final_norm, device=device,
            dtype=PRECISION_TO_TYPE[args.text_encoder_precision],
            generator=torch.Generator(device=device).manual_seed(2),
            llm_quant=args.text_encoder_quant,
            llm_comm=GroupComm() if tiers else None)
        return cls(args, vae, text_encoder, text_encoder_2, transformer,
                   logger=logger, sp_groups=groups,
                   memory_tiers=memory_tiers)


class HunyuanVideoSampler(Inference):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.pipeline = HunyuanVideoPipeline(
            vae=self.vae, text_encoder=self.text_encoder,
            text_encoder_2=self.text_encoder_2, transformer=self.transformer,
            scheduler=self._scheduler(self.args.flow_shift),
            cpu_offload=self.args.use_cpu_offload, device=self.device,
            sp=self.sp_groups)
        self.default_negative_prompt = NEGATIVE_PROMPT

    def _scheduler(self, shift: float) -> FlowMatchDiscreteScheduler:
        a = self.args
        return FlowMatchDiscreteScheduler(
            shift=shift, reverse=a.flow_reverse, solver=a.flow_solver,
            use_linear_quadratic_schedule=a.use_linear_quadratic_schedule,
            linear_schedule_end=a.linear_schedule_end)

    def predict(
        self,
        prompt: str,
        height: int = 192,
        width: int = 336,
        video_length: int = 129,
        seed: Union[int, List[int], None] = None,
        negative_prompt: Optional[str] = None,
        infer_steps: int = 50,
        guidance_scale: float = 6.0,
        flow_shift: float = 5.0,
        embedded_guidance_scale: Optional[float] = None,
        batch_size: int = 1,
        num_videos_per_prompt: int = 1,
        output_dtype: str = "float32",
        progress_callback=None,
    ) -> Dict[str, Any]:
        """(reference: predict, inference.py:497-671). Returns a dict with
        `samples` [B, 3, T, H, W] on the model's device, `seeds`, `size`,
        `prompts` and `gen_time` (seconds, host clock, synchronized)."""
        n_total = batch_size * num_videos_per_prompt
        if isinstance(seed, (int, np.integer)):
            seeds = [int(seed) + i for i in range(n_total)]
        elif seed is None:
            seeds = [int(s) for s in np.random.randint(0, 1_000_000, n_total)]
        elif isinstance(seed, (list, tuple)):
            seeds = [int(s) for s in seed][:n_total]
            seeds += [seeds[-1] + i + 1 for i in range(n_total - len(seeds))]
        else:
            raise ValueError(f"Seed must be int, list or None, got {seed}")
        dev = self.device
        gens = [torch.Generator(device=dev).manual_seed(s) for s in seeds]

        if video_length != 1 and (video_length - 1) % 4 != 0:
            raise ValueError(f"`video_length` has to be 1 or a multiple of 4 "
                             f"plus 1, got {video_length}")
        target_h, target_w = align_to(height, 16), align_to(width, 16)
        if not isinstance(prompt, str):
            raise TypeError(f"`prompt` must be a string, got {type(prompt)}")
        prompt = prompt.strip()
        if negative_prompt is None or negative_prompt == "":
            negative_prompt = self.default_negative_prompt
        if not isinstance(negative_prompt, str):
            raise TypeError(f"`negative_prompt` must be a string, got "
                            f"{type(negative_prompt)}")
        negative_prompt = negative_prompt.strip()

        self.pipeline.scheduler = self._scheduler(flow_shift)
        cos, sin, (tt, th, tw) = get_rotary_pos_embed(
            self.transformer.cfg, self.args.vae, video_length, target_h,
            target_w, device=dev)

        start = time.time()
        with maybe_trace(self.args.profile_dir):
            samples = self.pipeline(
                prompt=prompt, height=target_h, width=target_w,
                video_length=video_length, num_inference_steps=infer_steps,
                guidance_scale=guidance_scale,
                negative_prompt=negative_prompt,
                num_videos_per_prompt=num_videos_per_prompt,
                generator=gens if len(gens) > 1 else gens[0],
                embedded_guidance_scale=embedded_guidance_scale,
                freqs_cis=(cos, sin), n_tokens=tt * th * tw,
                vae_ver=self.args.vae, enable_tiling=self.args.vae_tiling,
                data_type="video" if video_length > 1 else "image",
                progress_callback=progress_callback,
                output_dtype=output_dtype).videos
            if samples.is_cuda:
                torch.cuda.synchronize(samples.device)
        gen_time = time.time() - start
        if self.logger:
            self.logger.info(f"Success, time: {gen_time}")
        return {"samples": samples, "seeds": seeds,
                "size": (target_h, target_w, video_length),
                "prompts": [prompt], "gen_time": gen_time}
