"""VAE configuration and the temporal-ops experiment config: copies of the
JAX package's models/vae_config.py.

`VAEConfig` mirrors the diffusers JSON config consumed by the reference
(reference: hyvideo/vae/autoencoder_kl_causal_3d.py:66-133, loaded at runtime
in hyvideo/vae/__init__.py:88). Defaults are the HunyuanVideo "884-16c-hy"
checkpoint values.

`TOpsConfig` is the immutable form of the fork's t_ops_config.json
runtime-surgery layer (reference: t_ops_config.json:1-92, applied by
hyvideo/vae/__init__.py:15-63): the encoder's and decoder's forwards read it
instead of monkey-patching built modules. `interp_mode` is parsed and
carried; every interpolation is nearest, as in the JAX package.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    act_fn: str = "silu"
    sample_size: int = 256
    sample_tsize: int = 64
    scaling_factor: float = 0.476986
    shift_factor: Optional[float] = None
    time_compression_ratio: int = 4
    spatial_compression_ratio: int = 8
    mid_block_add_attention: bool = True
    tile_overlap_factor: float = 0.25

    # ---- derived schedule (reference: hyvideo/vae/vae.py:59-96, 181-218) ----
    @property
    def num_blocks(self) -> int:
        return len(self.block_out_channels)

    def encoder_block_channels(self, i: int) -> Tuple[int, int]:
        cin = self.block_out_channels[0] if i == 0 else self.block_out_channels[i - 1]
        return cin, self.block_out_channels[i]

    def decoder_block_channels(self, i: int) -> Tuple[int, int]:
        rev = tuple(reversed(self.block_out_channels))
        cin = rev[0] if i == 0 else rev[i - 1]
        return cin, rev[i]

    def downsample_stride(self, i: int) -> Optional[Tuple[int, int, int]]:
        """Stride of block i's downsampler conv; None if no downsampler."""
        if self.time_compression_ratio != 4:
            raise ValueError(
                f"Unsupported time_compression_ratio {self.time_compression_ratio}")
        n_s = int(math.log2(self.spatial_compression_ratio))
        n_t = int(math.log2(self.time_compression_ratio))
        is_final = i == self.num_blocks - 1
        spatial = i < n_s
        temporal = i >= (self.num_blocks - 1 - n_t) and not is_final
        if not (spatial or temporal):
            return None
        return (2 if temporal else 1, 2 if spatial else 1, 2 if spatial else 1)

    def upsample_factor(self, i: int) -> Optional[Tuple[int, int, int]]:
        """Upsample factor of up-block i; None if no upsampler. Mirrors the
        encoder schedule (reference: hyvideo/vae/vae.py:190-201)."""
        return self.downsample_stride(i)

    # ---- tiling bookkeeping (reference: autoencoder_kl_causal_3d.py:117-133) ----
    @property
    def tile_sample_min_size(self) -> int:
        return self.sample_size

    @property
    def tile_latent_min_size(self) -> int:
        return int(self.sample_size / (2 ** (self.num_blocks - 1)))

    @property
    def tile_sample_min_tsize(self) -> int:
        return self.sample_tsize

    @property
    def tile_latent_min_tsize(self) -> int:
        return self.sample_tsize // self.time_compression_ratio

    @classmethod
    def from_json(cls, path: str) -> "VAEConfig":
        """The diffusers config.json of a checkpoint; unknown keys dropped."""
        with open(path) as f:
            raw = json.load(f)
        kwargs = {k: v for k, v in raw.items()
                  if k in cls.__dataclass_fields__}
        if "block_out_channels" in kwargs:
            kwargs["block_out_channels"] = tuple(kwargs["block_out_channels"])
        return cls(**kwargs)


# --------------------------------------------------------------------------
# Temporal-ops experiment config (the fork's research knob)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class DownBlockTOps:
    """Per encoder down-block hooks (reference:
    unet_causal_3d_blocks.py:736-790)."""

    pool_t_kernel: int = 2
    pool_t_stride: int = 2
    enable_t_pool_before_block: Tuple[bool, ...] = ()
    enable_t_pool_after_block: Tuple[bool, ...] = ()
    downsample_stride: Optional[Tuple[int, int, int]] = None


@dataclass(frozen=True)
class MidBlockTOps:
    """Mid-block pooling hooks (reference:
    unet_causal_3d_blocks.py:622-678)."""

    pool_t_kernel: int = 2
    pool_t_stride: int = 2
    enable_t_pool_before_block: Tuple[bool, ...] = ()
    enable_t_pool_after_block: Tuple[bool, ...] = ()


@dataclass(frozen=True)
class UpBlockTOps:
    """Per decoder up-block temporal-interp hooks (reference:
    unet_causal_3d_blocks.py:853-916)."""

    interp_t_scale_factor: int = 2
    interp_mode: str = "nearest"
    enable_t_interp_before_block: Tuple[bool, ...] = ()
    enable_t_interp_after_block: Tuple[bool, ...] = ()


def _flags(d: dict, key: str) -> Tuple[bool, ...]:
    return tuple(d.get(key, []))


def _parse_down(d: Optional[dict]) -> Optional[DownBlockTOps]:
    if d is None:
        return None
    ds = d.get("downsample_stride")
    return DownBlockTOps(
        pool_t_kernel=d.get("pool_t_kernel", 2),
        pool_t_stride=d.get("pool_t_stride", 2),
        enable_t_pool_before_block=_flags(d, "enable_t_pool_before_block"),
        enable_t_pool_after_block=_flags(d, "enable_t_pool_after_block"),
        downsample_stride=tuple(ds) if ds else None)


def _parse_mid(d: Optional[dict]) -> Optional[MidBlockTOps]:
    if d is None:
        return None
    return MidBlockTOps(
        pool_t_kernel=d.get("pool_t_kernel", 2),
        pool_t_stride=d.get("pool_t_stride", 2),
        enable_t_pool_before_block=_flags(d, "enable_t_pool_before_block"),
        enable_t_pool_after_block=_flags(d, "enable_t_pool_after_block"))


def _parse_up(d: Optional[dict]) -> Optional[UpBlockTOps]:
    if d is None:
        return None
    return UpBlockTOps(
        interp_t_scale_factor=d.get("interp_t_scale_factor", 2),
        interp_mode=d.get("interp_mode", "nearest"),
        enable_t_interp_before_block=_flags(d, "enable_t_interp_before_block"),
        enable_t_interp_after_block=_flags(d, "enable_t_interp_after_block"))


@dataclass(frozen=True)
class TOpsConfig:
    """The encoder's per down-block and mid-block hooks and the decoder's
    per up-block and mid-block hooks; blocks past the listed ones (and None
    entries) run unchanged. Hashable, so a VAE can hold it as a constant."""

    down_blocks: Tuple[Optional[DownBlockTOps], ...] = ()
    encoder_mid_block: Optional[MidBlockTOps] = None
    up_blocks: Tuple[Optional[UpBlockTOps], ...] = ()
    decoder_mid_block: Optional[MidBlockTOps] = None

    @classmethod
    def from_json(cls, path: str) -> "TOpsConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_dict(cls, raw: dict) -> "TOpsConfig":
        enc = raw.get("encoder", {})
        dec = raw.get("decoder", {})
        return cls(
            down_blocks=tuple(_parse_down(d)
                              for d in enc.get("down_blocks", [])),
            encoder_mid_block=_parse_mid(enc.get("mid_block")),
            up_blocks=tuple(_parse_up(d) for d in dec.get("up_blocks", [])),
            decoder_mid_block=_parse_mid(dec.get("mid_block")))

    def down(self, i: int) -> Optional[DownBlockTOps]:
        return self.down_blocks[i] if i < len(self.down_blocks) else None

    def up(self, i: int) -> Optional[UpBlockTOps]:
        return self.up_blocks[i] if i < len(self.up_blocks) else None


# Name-keyed registry (reference encodes the arch in the VAE name
# "<t><s><s>-<c>c-<tag>", hyvideo/config.py:384-397; the full config is the
# diffusers JSON in the checkpoint dir, defaults above).
# Only the x4 temporal architecture exists (the reference raises for any
# other time_compression_ratio, hyvideo/vae/vae.py:77; "888" names are
# handled at the pipeline's latent-frame math only).
VAE_CONFIGS = {
    "884-16c-hy": VAEConfig(),
}


def load_vae_config(name: str, **overrides) -> VAEConfig:
    from dataclasses import replace

    if name not in VAE_CONFIGS:
        raise ValueError(f"Unknown VAE {name}; have {list(VAE_CONFIGS)}")
    cfg = VAE_CONFIGS[name]
    return replace(cfg, **overrides) if overrides else cfg
