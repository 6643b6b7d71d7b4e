"""VAE configuration: a copy of the JAX package's `VAEConfig` and its
registry (the temporal-ops `TOpsConfig` is not ported yet).

`VAEConfig` mirrors the diffusers JSON config consumed by the reference
(reference: hyvideo/vae/autoencoder_kl_causal_3d.py:66-133, loaded at runtime
in hyvideo/vae/__init__.py:88). Defaults are the HunyuanVideo "884-16c-hy"
checkpoint values.
"""
from __future__ import annotations

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
