"""DiT configuration (reference: hyvideo/modules/models.py:448-760); a copy
of the JAX package's models/dit_config.py without its TPU dispatch and
sequence-parallel fields."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class DiTConfig:
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    in_channels: int = 16
    out_channels: int = 16
    hidden_size: int = 3072
    heads_num: int = 24
    mlp_width_ratio: float = 4.0
    mlp_act_type: str = "gelu_tanh"
    mm_double_blocks_depth: int = 20
    mm_single_blocks_depth: int = 40
    rope_dim_list: Tuple[int, int, int] = (16, 56, 56)
    qkv_bias: bool = True
    qk_norm: bool = True
    qk_norm_type: str = "rms"
    guidance_embed: bool = False
    text_states_dim: int = 4096
    text_states_dim_2: int = 768
    text_projection: str = "single_refiner"
    use_attention_mask: bool = True
    rope_theta: float = 256.0
    # auto | flash | flash_int8 | sdpa | chunked | sta | sta_int8
    attn_mode: str = "auto"
    # Sliding Tile Attention (attn_mode="sta"; ops/sta.py): tile shape in
    # (t, h, w) patch-grid units and the sliding window in tiles.
    sta_tile: Tuple[int, int, int] = (4, 8, 8)
    sta_window: Tuple[int, int, int] = (3, 3, 3)
    # First N double/single blocks keep dense attention under "sta" (the
    # paper keeps a few full-attention layers for quality).
    sta_dense_double_blocks: int = 0
    sta_dense_single_blocks: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.heads_num

    @property
    def mlp_hidden_dim(self) -> int:
        return int(self.hidden_size * self.mlp_width_ratio)

    def __post_init__(self):
        if self.hidden_size % self.heads_num != 0:
            raise ValueError(
                f"hidden_size {self.hidden_size} % heads_num {self.heads_num} != 0")
        if sum(self.rope_dim_list) != self.head_dim:
            raise ValueError(
                f"sum(rope_dim_list) {sum(self.rope_dim_list)} != head_dim {self.head_dim}")


# Registry (reference: hyvideo/modules/models.py:742-760 +
# hyvideo/modules/__init__.py:4-26)
HUNYUAN_VIDEO_CONFIG = {
    "HYVideo-T/2": DiTConfig(),
    "HYVideo-T/2-cfgdistill": DiTConfig(guidance_embed=True),
}


def load_dit_config(name: str, **overrides) -> DiTConfig:
    if name not in HUNYUAN_VIDEO_CONFIG:
        raise ValueError(f"Unknown model name {name}; have {list(HUNYUAN_VIDEO_CONFIG)}")
    return replace(HUNYUAN_VIDEO_CONFIG[name], **overrides)
