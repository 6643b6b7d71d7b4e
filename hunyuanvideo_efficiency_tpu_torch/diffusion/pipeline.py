"""HunyuanVideo text-to-video pipeline on one GPU (JAX counterpart:
diffusion/pipeline.py; reference:
hyvideo/diffusion/pipelines/pipeline_hunyuan_video.py:144-1100).

A host loop over `denoise_step`: latents stay fp32 through the Euler step
while the DiT computes in its own precision (bf16 on the card). Kept from
the reference: CFG batch order [negative, positive] (:896-903), guidance
embedding = embedded_cfg_scale * 1000 (:976-985), rescale_noise_cfg
(arXiv 2305.08891 §3.4, :56-71), latents / scaling_factor (+ shift_factor)
before decode (:1060-1069) and video = clamp(image / 2 + 0.5, 0, 1)
(:1090).

Under sequence parallelism (`sp`, this rank's parallel.mesh.SPGroups) the
denoise loop is `_denoise_sharded` (JAX diffusion/pipeline.py:299-420): the
latent stays token-sharded for every step and is gathered once before the
decode. Every rank runs the text encoding and the decode: with the memory
tiers (inference.py) the Llama tower is one tensor-parallel forward over the
ranks and a tiled decode spreads its tiles over them (JAX
inference.py:187-200); a weight-sharded DiT (`--shard-dit-weights`) gathers
its chunks inside its forward. Spans (utils/profiling.py:span):
`text_encode` around `encode_prompt`, `step` around each `denoise_step`,
`decode` around the VAE decode. `denoise_step.LAUNCHES` counts the DiT's
batch rows of every step (2 under CFG, 1 without).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple, Union

import torch
import torch.nn as nn

from ..models.dit import HYVideoDiT
from ..models.vae import AutoencoderKLCausal3D
from ..utils.profiling import span
from .scheduler import FlowMatchDiscreteScheduler, euler_step


def sample_mean(x: torch.Tensor) -> torch.Tensor:
    """Each sample's mean over all but the batch dim, kept as [B, 1, ...]."""
    return x.mean(dim=tuple(range(1, x.ndim)), keepdim=True)


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor,
                      guidance_rescale: float,
                      mean: Callable = sample_mean) -> torch.Tensor:
    """(reference: pipeline_hunyuan_video.py:56-71). `mean` takes each
    sample's mean; on a token shard (sequence parallelism) it is the mean
    over the whole sequence of the sp group."""
    def std(x):
        return mean((x - mean(x)).square()).sqrt()

    rescaled = noise_cfg * (std(noise_pred_text) / std(noise_cfg))
    return guidance_rescale * rescaled + (1 - guidance_rescale) * noise_cfg


@torch.no_grad()
def denoise_step(transformer: HYVideoDiT, latents: torch.Tensor,
                 sigma: float, sigma_next: float, t: float,
                 prompt_embeds, prompt_mask, prompt_embeds_2,
                 freqs_cos, freqs_sin, do_cfg: bool, guidance_scale: float,
                 embedded_guidance_scale: Optional[float],
                 guidance_rescale: float, sp=None,
                 token_grid=None) -> torch.Tensor:
    """One flow-match Euler step with classifier-free guidance. Under
    sequence parallelism (`sp`, this rank's parallel.mesh.SPGroups)
    `latents` is this rank's flat token shard of the `token_grid` patch
    grid, the DiT runs `forward_tokens`, and the guidance rescale's moments
    are means over the sp group; dp shards hold other samples and are not
    mixed."""
    latent_in = torch.cat([latents] * 2) if do_cfg else latents
    n = latent_in.shape[0]
    denoise_step.LAUNCHES += n
    dev = latents.device
    t_expand = torch.full((n,), t, dtype=torch.float32, device=dev)
    # without a scale a guidance-distilled DiT gets None and raises in its
    # forward, as the published model does (reference: :976-985)
    guidance = None
    if transformer.cfg.guidance_embed and embedded_guidance_scale is not None:
        guidance = torch.full((n,), embedded_guidance_scale * 1000.0,
                              dtype=torch.float32, device=dev)
    inputs = (latent_in, t_expand, prompt_embeds, prompt_mask,
              prompt_embeds_2, freqs_cos, freqs_sin, guidance)
    mean = sample_mean
    if sp is None:
        v = transformer(*inputs).float()
    else:
        from ..parallel.sp_dit import sp_mean

        v = transformer.forward_tokens(*inputs, token_grid=token_grid,
                                       sp=sp).float()
        mean = functools.partial(sp_mean, g=sp)
    if do_cfg:
        v_uncond, v_text = v.chunk(2)
        v = v_uncond + guidance_scale * (v_text - v_uncond)
        if guidance_rescale > 0.0:
            v = rescale_noise_cfg(v, v_text, guidance_rescale, mean)
    return euler_step(latents, v, sigma, sigma_next)


# counts the DiT's batch rows, not calls: 2 a CFG step, 1 a step without
# CFG (the guidance-distilled mode), the local rows under sp
denoise_step.LAUNCHES = 0


@dataclass
class HunyuanVideoPipelineOutput:
    videos: torch.Tensor  # [B, C, T, H, W], float32/float16 in [0, 1] or uint8


class HunyuanVideoPipeline:
    """Text encoding -> denoise loop -> VAE decode. The encoders may be None
    when prompt embeddings are passed in.

    cpu_offload: the reference's sequential offload (JAX
    diffusion/pipeline.py:211-260, :427-438, :493-570): only the phase that
    runs keeps its module on `device`; when the next phase starts (towers
    -> DiT -> VAE) the others go to the host first, so the device's peak is
    the largest phase, not the sum. The video is the same."""

    vae_scale_factor = 8
    HOST = torch.device("cpu")

    def __init__(self, vae: AutoencoderKLCausal3D, text_encoder,
                 text_encoder_2, transformer: HYVideoDiT,
                 scheduler: FlowMatchDiscreteScheduler,
                 cpu_offload: bool = False, device=None, sp=None):
        self.vae = vae
        self.text_encoder = text_encoder
        self.text_encoder_2 = text_encoder_2
        self.transformer = transformer
        self.scheduler = scheduler
        self.cpu_offload = cpu_offload
        self.sp = sp
        self.device = torch.device(
            device if device is not None
            else next(transformer.parameters()).device)

    def _place(self, phase: str) -> None:
        """Under cpu_offload: every other phase's modules to the host, then
        `phase`'s ("text", "dit" or "vae") to the device (a tensor-parallel
        tower's or a weight-sharded DiT's shards as they are)."""
        from ..parallel.weight_shard import place_dit

        if not self.cpu_offload:
            return
        towers = [enc.model for enc in (self.text_encoder,
                                        self.text_encoder_2)
                  if enc is not None]
        mods = {"text": towers, "dit": [self.transformer], "vae": [self.vae]}
        for name, group in mods.items():
            if name != phase:
                for m in group:
                    (place_dit if m is self.transformer
                     else nn.Module.to)(m, self.HOST)
        for m in mods[phase]:
            (place_dit if m is self.transformer else nn.Module.to)(
                m, self.device)

    @staticmethod
    def check_inputs(height: int, width: int, video_length: int,
                     vae_ver: str = "884-16c-hy"):
        """(reference: :482-555)."""
        if height % 8 != 0 or width % 8 != 0:
            raise ValueError(f"`height` and `width` have to be divisible by "
                             f"8 but are {height} and {width}.")
        step = 4 if "884" in vae_ver else 8 if "888" in vae_ver else None
        if step and video_length != 1 and (video_length - 1) % step != 0:
            raise ValueError(f"`video_length` has to be 1 or a multiple of "
                             f"{step} plus 1 but is {video_length}.")

    def encode_prompt(self, prompt, negative_prompt, do_cfg: bool,
                      data_type: str = "video",
                      num_videos_per_prompt: int = 1):
        """Both encoders; [neg, pos] concatenated under CFG (reference:
        encode_prompt :238-449, concat :896-903), in a `text_encode`
        span."""
        with span("text_encode"):
            pe, mask = self.text_encoder.encode_prompt(
                prompt, data_type=data_type, num_videos=num_videos_per_prompt)
            pe2, _ = self.text_encoder_2.encode_prompt(
                prompt, data_type=data_type, num_videos=num_videos_per_prompt)
            if isinstance(prompt, (list, tuple)) \
                    and isinstance(negative_prompt, str):
                negative_prompt = [negative_prompt] * len(prompt)
            if do_cfg:
                npe, nmask = self.text_encoder.encode_prompt(
                    negative_prompt, data_type=data_type,
                    num_videos=num_videos_per_prompt)
                npe2, _ = self.text_encoder_2.encode_prompt(
                    negative_prompt, data_type=data_type,
                    num_videos=num_videos_per_prompt)
                pe = torch.cat([npe, pe])
                mask = torch.cat([nmask, mask])
                pe2 = torch.cat([npe2, pe2])
            return pe, mask, pe2

    def _denoise_sharded(self, latents, sigmas, timesteps, pe, mask, pe2,
                         freqs_cis, do_cfg: bool, guidance_scale: float,
                         embedded_guidance_scale: Optional[float],
                         guidance_rescale: float, progress_callback=None):
        """The denoise loop on this rank's shard: its dp slice of the batch
        (and of each CFG half) and its ring-major token block as flat patch
        tokens, with the RoPE rows of those tokens, conditioned on rank 0's
        text embeddings (CLIP-L's pooled vector is each rank's own); one
        gather over sp
        and dp at the end returns the whole [B, C, T, H, W] latent on every
        rank. progress_callback gets the local token shard."""
        from ..models.dit import patchify_raw, unpatchify
        from ..parallel.sp_dit import (cfg_local, check_sp_compat,
                                       from_rank0, gather_tokens)

        g = self.sp
        cfg = self.transformer.cfg
        b, _, lt_, lh, lw = latents.shape
        pt, ph, pw = cfg.patch_size
        grid = (lt_ // pt, lh // ph, lw // pw)
        check_sp_compat(cfg, g.pcfg, grid, b)
        tokens = patchify_raw(latents, cfg.patch_size)
        rows, toks = g.batch_range(b), g.token_range(tokens.shape[1])
        local = tokens[rows, toks].contiguous()
        f_cos, f_sin = (f[toks] for f in freqs_cis)
        pe, mask, pe2 = (None if x is None else cfg_local(x, g) if do_cfg
                         else x[rows]
                         for x in map(from_rank0, (pe, mask, pe2)))
        for i in range(len(timesteps)):
            with span("step"):
                local = denoise_step(
                    self.transformer, local, float(sigmas[i]),
                    float(sigmas[i + 1]), float(timesteps[i]), pe, mask,
                    pe2, f_cos, f_sin, do_cfg, guidance_scale,
                    embedded_guidance_scale, guidance_rescale, sp=g,
                    token_grid=grid)
            if progress_callback is not None:
                progress_callback(i, local)
        return unpatchify(gather_tokens(local, g), *grid, cfg.out_channels,
                          cfg.patch_size)

    @torch.no_grad()
    def __call__(
        self,
        prompt: Optional[Union[str, List[str]]] = None,
        height: int = 720,
        width: int = 1280,
        video_length: int = 129,
        *,
        num_inference_steps: int = 50,
        guidance_scale: float = 1.0,
        negative_prompt: Optional[str] = None,
        num_videos_per_prompt: int = 1,
        generator: Optional[Union[torch.Generator,
                                  List[torch.Generator]]] = None,
        latents: Optional[torch.Tensor] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        prompt_mask: Optional[torch.Tensor] = None,
        prompt_embeds_2: Optional[torch.Tensor] = None,
        guidance_rescale: float = 0.0,
        embedded_guidance_scale: Optional[float] = None,
        freqs_cis: Tuple[torch.Tensor, torch.Tensor] = None,
        vae_ver: str = "884-16c-hy",
        enable_tiling: bool = False,
        data_type: str = "video",
        n_tokens: Optional[int] = None,
        progress_callback=None,
        output_type: str = "video",
        output_dtype: str = "float32",
    ) -> HunyuanVideoPipelineOutput:
        self.check_inputs(height, width, video_length, vae_ver)
        if output_dtype not in ("float32", "float16", "uint8"):
            raise ValueError(f"output_dtype must be float32|float16|uint8, "
                             f"got {output_dtype!r}")
        do_cfg = guidance_scale > 1.0
        if prompt_embeds is None:
            self._place("text")
            pe, mask, pe2 = self.encode_prompt(prompt, negative_prompt, do_cfg,
                                               data_type,
                                               num_videos_per_prompt)
        else:
            pe, mask, pe2 = prompt_embeds, prompt_mask, prompt_embeds_2
        batch = pe.shape[0] // (2 if do_cfg else 1)

        self.scheduler.set_timesteps(num_inference_steps, n_tokens=n_tokens)
        sigmas = self.scheduler.sigmas
        timesteps = self.scheduler.timesteps

        if "884" in vae_ver:
            latent_t = (video_length - 1) // 4 + 1
        elif "888" in vae_ver:
            latent_t = (video_length - 1) // 8 + 1
        else:
            latent_t = video_length
        cfg = self.transformer.cfg
        shape = (batch, cfg.in_channels, latent_t,
                 height // self.vae_scale_factor,
                 width // self.vae_scale_factor)
        dev = pe.device
        if latents is None:
            if generator is None:
                raise ValueError("need a torch.Generator when latents are "
                                 "not given")
            gens = (generator if isinstance(generator, (list, tuple))
                    else [generator])
            if len(gens) == 1:
                latents = torch.randn(shape, generator=gens[0], device=dev)
            else:
                if len(gens) != batch:
                    raise ValueError(f"{len(gens)} generators for batch "
                                     f"{batch}")
                # one generator per video: each sample reproducible alone
                latents = torch.stack([torch.randn(shape[1:], generator=g,
                                                   device=dev) for g in gens])
        latents = latents.to(device=dev, dtype=torch.float32)

        egs = (float(embedded_guidance_scale)
               if embedded_guidance_scale is not None else None)
        self._place("dit")
        if self.sp is not None:
            latents = self._denoise_sharded(
                latents, sigmas, timesteps, pe, mask, pe2, freqs_cis, do_cfg,
                float(guidance_scale), egs, float(guidance_rescale),
                progress_callback)
        else:
            for i in range(len(timesteps)):
                with span("step"):
                    latents = denoise_step(
                        self.transformer, latents, float(sigmas[i]),
                        float(sigmas[i + 1]), float(timesteps[i]), pe, mask,
                        pe2, freqs_cis[0], freqs_cis[1], do_cfg,
                        float(guidance_scale), egs, float(guidance_rescale))
                if progress_callback is not None:
                    progress_callback(i, latents)

        if output_type == "latent":
            return HunyuanVideoPipelineOutput(videos=latents)

        self._place("vae")
        vcfg = self.vae.cfg
        z = latents / vcfg.scaling_factor
        if vcfg.shift_factor:
            z = z + vcfg.shift_factor
        self.vae.enable_tiling(enable_tiling)
        with span("decode"):
            image = self.vae.decode(z)
        image = (image.float() / 2 + 0.5).clamp(0.0, 1.0)
        if output_dtype == "uint8":
            image = torch.round(image * 255.0).to(torch.uint8)
        elif output_dtype == "float16":
            image = image.half()
        return HunyuanVideoPipelineOutput(videos=image)
