"""Argument/config system of the one-GPU port (JAX counterpart: config.py;
reference: hyvideo/config.py:7-398).

The flags of the reference `sample_video.py` that the single-GPU path reads
are kept unchanged, with the JAX package's `--attn-mode sta|flash_int8|
sta_int8`, `--sta-window`, `--sta-dense-blocks` and the weight tiers
`--use-fp8`, `--use-int8`, `--use-int4-modulation` and
`--text-encoder-quant int8`, and `--use-cpu-offload` (sequential offload
in diffusion/pipeline.py). `--disable-autocast` and `--reproduce` are
parsed and stored, and change nothing, as in the JAX package.
`--ulysses-degree`, `--ring-degree` and `--mesh-shape` set the sequence-
parallel layout (parallel/mesh.py:parallel_config), run under torchrun;
`--profile-dir` writes a torch.profiler trace of each `predict`
(utils/profiling.py). `--shard-dit-weights` weight-shards the DiT's block
stacks over the sp ranks (parallel/weight_shard.py; replication where the
sp degree is 1, as in JAX).
"""
from __future__ import annotations

import argparse
import re
from dataclasses import dataclass, fields
from typing import List, Optional, Tuple

VAE_NAME_RE = re.compile(r"^(\d)(\d)(\d)-(\d+)c-(\w+)$")


@dataclass(frozen=True)
class VaeNameInfo:
    """Parsed "<s><s><t>-<c>c-<tag>" VAE name: "884-16c-hy" = spatial x8,
    time x4, 16 latent channels."""

    time_ratio: int
    spatial_ratio: int
    latent_channels: int
    tag: str
    name: str

    def latent_frames(self, video_length: int) -> int:
        """Causal VAEs: (f - 1) / t_ratio + 1 latent frames
        (reference: hyvideo/inference.py:454-459)."""
        if self.time_ratio == 1:
            return video_length
        return (video_length - 1) // self.time_ratio + 1


def parse_vae_name(name: str) -> VaeNameInfo:
    m = VAE_NAME_RE.match(name)
    if not m:
        raise ValueError(f"Invalid VAE name: {name}. Expected format like "
                         f"'884-16c-hy'.")
    s1, s2, t, c, tag = m.groups()
    if s1 != s2:
        raise ValueError(f"VAE name {name}: anisotropic spatial ratios "
                         f"unsupported.")
    return VaeNameInfo(time_ratio=int(t), spatial_ratio=int(s1),
                       latent_channels=int(c), tag=tag, name=name)


ATTN_MODES = ("auto", "flash", "flash_int8", "sdpa", "chunked", "sta",
              "sta_int8")
TEXT_ENCODER_QUANTS = (None, "int8")


@dataclass
class InferenceArgs:
    """Flat argument namespace, flag-compatible with the reference CLI."""

    # network (reference config.py:22-51)
    model: str = "HYVideo-T/2-cfgdistill"
    latent_channels: Optional[int] = None
    precision: str = "bf16"
    rope_theta: int = 256
    # extra models (reference config.py:54-172)
    vae: str = "884-16c-hy"
    vae_precision: str = "fp16"
    vae_tiling: bool = True
    text_encoder: str = "llm"
    text_encoder_precision: str = "fp16"
    text_states_dim: int = 4096
    text_len: int = 256
    tokenizer: str = "llm"
    prompt_template: str = "dit-llm-encode"
    prompt_template_video: str = "dit-llm-encode-video"
    hidden_state_skip_layer: int = 2
    apply_final_norm: bool = False
    text_encoder_2: str = "clipL"
    text_encoder_precision_2: str = "fp16"
    text_states_dim_2: int = 768
    tokenizer_2: str = "clipL"
    text_len_2: int = 77
    # denoise schedule (reference config.py:175-216)
    denoise_type: str = "flow"
    flow_shift: float = 7.0
    flow_reverse: bool = True
    flow_solver: str = "euler"
    use_linear_quadratic_schedule: bool = False
    linear_schedule_end: int = 25
    # inference (reference config.py:219-361)
    model_base: str = "ckpts"
    dit_weight: Optional[str] = None
    model_resolution: str = "540p"
    load_key: str = "module"
    # sequential offload (reference inference.py:443-446): each phase's
    # module goes back to the host when the next phase starts
    use_cpu_offload: bool = False
    batch_size: int = 1
    infer_steps: int = 50
    # parsed for flag compatibility, as in the JAX package: the port computes
    # in the modules' own precision and draws every random number from an
    # explicit seeded torch.Generator, so neither flag changes anything
    disable_autocast: bool = False
    reproduce: bool = False
    save_path: str = "./results"
    save_path_suffix: str = ""
    name_suffix: str = ""
    num_videos: int = 1
    video_size: Tuple[int, int] = (720, 1280)
    video_length: int = 129
    prompt: Optional[str] = None
    seed_type: str = "auto"
    seed: Optional[int] = None
    neg_prompt: Optional[str] = None
    cfg_scale: float = 1.0
    embedded_cfg_scale: float = 6.0
    attn_mode: str = "auto"
    sta_window: Tuple[int, int, int] = (3, 3, 3)
    sta_dense_blocks: int = 0  # dense-attention prefix depth under sta
    device: str = "cuda"
    # weight tiers (ops/quantization.py), applied in this order
    use_fp8: bool = False
    use_int8: bool = False
    use_int4_modulation: bool = False
    text_encoder_quant: Optional[str] = None   # None | "int8" (the LLM)
    # sequence parallelism (reference config.py:364-381; JAX mesh_shape
    # "dp:2,ulysses:2,ring:2", sp an alias of ulysses)
    ulysses_degree: int = 1
    ring_degree: int = 1
    mesh_shape: Optional[str] = None
    # a torch.profiler chrome trace of each predict (utils/profiling.py)
    profile_dir: Optional[str] = None
    # the weight-sharded DiT stacks over the sp ranks (parallel/
    # weight_shard.py); replication where sp is 1
    shard_dit_weights: bool = False

    def __post_init__(self):
        self.vae_info = parse_vae_name(self.vae)
        if self.latent_channels is None:
            self.latent_channels = self.vae_info.latent_channels
        if self.vae_info.latent_channels != self.latent_channels:
            raise ValueError(f"Latent channels {self.latent_channels} != VAE "
                             f"channels {self.vae_info.latent_channels}")
        if self.attn_mode not in ATTN_MODES:
            raise ValueError(f"attn_mode must be one of {ATTN_MODES}, got "
                             f"{self.attn_mode!r}")
        if self.text_encoder_quant not in TEXT_ENCODER_QUANTS:
            raise ValueError(f"text encoder quant must be int8|None: "
                             f"{self.text_encoder_quant}")
        from .parallel.mesh import parallel_config

        pcfg = parallel_config(self)
        if min(pcfg.dp_degree, pcfg.ulysses_degree, pcfg.ring_degree) < 1:
            raise ValueError(f"parallel degrees must be >= 1: {pcfg}")


def _add_bool_flag(parser, name, default, help_=""):
    dest = name.replace("-", "_")
    group = parser.add_mutually_exclusive_group()
    group.add_argument(f"--{name}", dest=dest, action="store_true", help=help_)
    group.add_argument(f"--no-{name}", dest=dest, action="store_false")
    parser.set_defaults(**{dest: default})


def build_parser() -> argparse.ArgumentParser:
    d = InferenceArgs()
    p = argparse.ArgumentParser(description="HunyuanVideo on one GPU")

    g = p.add_argument_group("network")
    g.add_argument("--model", type=str, default=d.model)
    g.add_argument("--latent-channels", type=int, default=None)
    g.add_argument("--precision", type=str, default=d.precision,
                   choices=["fp32", "fp16", "bf16"])
    g.add_argument("--rope-theta", type=int, default=d.rope_theta)

    g = p.add_argument_group("extra models")
    g.add_argument("--vae", type=str, default=d.vae)
    g.add_argument("--vae-precision", type=str, default=d.vae_precision)
    _add_bool_flag(p, "vae-tiling", d.vae_tiling)
    g.add_argument("--text-encoder", type=str, default=d.text_encoder)
    g.add_argument("--text-encoder-precision", type=str,
                   default=d.text_encoder_precision)
    g.add_argument("--text-states-dim", type=int, default=d.text_states_dim)
    g.add_argument("--text-len", type=int, default=d.text_len)
    g.add_argument("--tokenizer", type=str, default=d.tokenizer)
    g.add_argument("--prompt-template", type=str, default=d.prompt_template)
    g.add_argument("--prompt-template-video", type=str,
                   default=d.prompt_template_video)
    g.add_argument("--hidden-state-skip-layer", type=int,
                   default=d.hidden_state_skip_layer)
    _add_bool_flag(p, "apply-final-norm", d.apply_final_norm)
    g.add_argument("--text-encoder-2", type=str, default=d.text_encoder_2)
    g.add_argument("--text-encoder-precision-2", type=str,
                   default=d.text_encoder_precision_2)
    g.add_argument("--text-encoder-quant", type=str,
                   default=d.text_encoder_quant, choices=["int8"])
    g.add_argument("--text-states-dim-2", type=int,
                   default=d.text_states_dim_2)
    g.add_argument("--tokenizer-2", type=str, default=d.tokenizer_2)
    g.add_argument("--text-len-2", type=int, default=d.text_len_2)

    g = p.add_argument_group("denoise")
    g.add_argument("--denoise-type", type=str, default=d.denoise_type)
    g.add_argument("--flow-shift", type=float, default=d.flow_shift)
    _add_bool_flag(p, "flow-reverse", d.flow_reverse)
    g.add_argument("--flow-solver", type=str, default=d.flow_solver)
    _add_bool_flag(p, "use-linear-quadratic-schedule",
                   d.use_linear_quadratic_schedule)
    g.add_argument("--linear-schedule-end", type=int,
                   default=d.linear_schedule_end)

    g = p.add_argument_group("inference")
    g.add_argument("--model-base", type=str, default=d.model_base)
    g.add_argument("--dit-weight", type=str, default=None)
    g.add_argument("--model-resolution", type=str, default=d.model_resolution,
                   choices=["540p", "720p"])
    g.add_argument("--load-key", type=str, default=d.load_key,
                   choices=["module", "ema"])
    _add_bool_flag(p, "use-cpu-offload", d.use_cpu_offload)
    g.add_argument("--batch-size", type=int, default=d.batch_size)
    g.add_argument("--infer-steps", type=int, default=d.infer_steps)
    _add_bool_flag(p, "disable-autocast", d.disable_autocast)
    g.add_argument("--save-path", type=str, default=d.save_path)
    g.add_argument("--save-path-suffix", type=str, default=d.save_path_suffix)
    g.add_argument("--name-suffix", type=str, default=d.name_suffix)
    g.add_argument("--num-videos", type=int, default=d.num_videos)
    g.add_argument("--video-size", type=int, nargs="+",
                   default=list(d.video_size))
    g.add_argument("--video-length", type=int, default=d.video_length)
    g.add_argument("--prompt", type=str, default=None)
    g.add_argument("--seed-type", type=str, default=d.seed_type,
                   choices=["file", "random", "fixed", "auto"])
    g.add_argument("--seed", type=int, default=None)
    g.add_argument("--neg-prompt", type=str, default=None)
    g.add_argument("--cfg-scale", type=float, default=d.cfg_scale)
    g.add_argument("--embedded-cfg-scale", type=float,
                   default=d.embedded_cfg_scale)
    g.add_argument("--attn-mode", type=str, default=d.attn_mode,
                   choices=list(ATTN_MODES))
    g.add_argument("--sta-window", type=int, nargs=3,
                   default=list(d.sta_window))
    g.add_argument("--sta-dense-blocks", type=int, default=d.sta_dense_blocks)
    g.add_argument("--device", type=str, default=d.device)
    _add_bool_flag(p, "use-fp8", d.use_fp8)
    _add_bool_flag(p, "use-int8", d.use_int8)
    _add_bool_flag(p, "use-int4-modulation", d.use_int4_modulation)
    _add_bool_flag(p, "reproduce", d.reproduce)

    g = p.add_argument_group("parallel")
    g.add_argument("--ulysses-degree", type=int, default=d.ulysses_degree)
    g.add_argument("--ring-degree", type=int, default=d.ring_degree)
    g.add_argument("--mesh-shape", type=str, default=None)
    _add_bool_flag(p, "shard-dit-weights", d.shard_dit_weights)
    g.add_argument("--profile-dir", type=str, default=None)
    return p


def parse_args(argv: Optional[List[str]] = None) -> InferenceArgs:
    ns = build_parser().parse_args(argv)
    valid = {f.name for f in fields(InferenceArgs)}
    kwargs = {k: v for k, v in vars(ns).items() if k in valid}
    vs = kwargs["video_size"]
    kwargs["video_size"] = tuple(vs * 2 if len(vs) == 1 else vs)
    kwargs["sta_window"] = tuple(kwargs["sta_window"])
    return InferenceArgs(**kwargs)
