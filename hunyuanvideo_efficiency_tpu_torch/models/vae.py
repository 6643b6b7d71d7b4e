"""Causal-3D VAE (JAX counterpart: models/vae.py; reference:
hyvideo/vae/autoencoder_kl_causal_3d.py:53-578, vae.py:32-294,
unet_causal_3d_blocks.py:49-916).

Module names follow the reference checkpoint (CausalConv3d wraps `.conv`),
so a reference `.pt` loads with `load_state_dict`. Compute is channels-last
[B, T, H, W, C] through ops/conv3d.py, whose stride-1 3x3x3 convs at 128+
channels run the CUDA kernel K3; the public encode/decode take and return
the reference's [B, C, T, H, W]. The mid-block attention is single-head and
frame-causal. Decode (and encode) tile spatially and temporally with the
reference's linear blending. The fork's temporal ops (pooling in the
encoder, a downsampler stride override, nearest interpolation in the
decoder) are read from a `TOpsConfig`, as the JAX forwards read it
(models/vae.py:196-288).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import (chunked_attention, frame_causal_block_bias,
                             sdpa_attention)
from ..ops.conv3d import (causal_avg_pool_t, causal_conv3d, conv3d_1x1,
                          interpolate_nearest_t, upsample_nearest_causal_3d)
from ..ops.norms import group_norm
from .vae_config import MidBlockTOps, TOpsConfig, VAEConfig


class CausalConv3d(nn.Module):
    """Key `<name>.conv`; the weight stays [Cout, Cin, kt, kh, kw]."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride=(1, 1, 1),
                 **fk):
        super().__init__()
        self.stride = tuple(stride)
        self.conv = nn.Conv3d(cin, cout, k, **fk)

    def forward(self, x, stride=None):
        """`stride` overrides the constructed one (the t-ops downsampler
        stride)."""
        return causal_conv3d(x, self.conv.weight.permute(2, 3, 4, 1, 0),
                             self.conv.bias,
                             stride=self.stride if stride is None else stride)


class GroupNorm(nn.Module):
    def __init__(self, groups: int, c: int, **fk):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(c, **fk))
        self.bias = nn.Parameter(torch.zeros(c, **fk))

    def forward(self, x):
        return group_norm(x, self.groups, self.weight, self.bias)


class ResnetBlock(nn.Module):
    """GN -> SiLU -> conv -> GN -> SiLU -> conv, plus shortcut
    (reference: unet_causal_3d_blocks.py:350-417, temb=None)."""

    def __init__(self, cin: int, cout: int, groups: int, **fk):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, **fk)
        self.conv1 = CausalConv3d(cin, cout, **fk)
        self.norm2 = GroupNorm(groups, cout, **fk)
        self.conv2 = CausalConv3d(cout, cout, **fk)
        self.conv_shortcut = (CausalConv3d(cin, cout, k=1, **fk)
                              if cin != cout else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class MidAttention(nn.Module):
    """Single-head frame-causal attention with residual (diffusers Attention
    with residual_connection=True, upcast_softmax=True)."""

    def __init__(self, c: int, groups: int, **fk):
        super().__init__()
        self.group_norm = GroupNorm(groups, c, **fk)
        self.to_q = nn.Linear(c, c, **fk)
        self.to_k = nn.Linear(c, c, **fk)
        self.to_v = nn.Linear(c, c, **fk)
        self.to_out = nn.ModuleList([nn.Linear(c, c, **fk)])

    def forward(self, x):
        b, t, hh, ww, c = x.shape
        n_hw = hh * ww
        seq = x.reshape(b, t * n_hw, c)
        h = self.group_norm(seq)
        q = self.to_q(h)[:, :, None]
        k = self.to_k(h)[:, :, None]
        v = self.to_v(h)[:, :, None]
        l = t * n_hw
        if l <= 4096:
            idx = torch.arange(l, device=x.device) // n_hw
            bias = torch.where(idx[None, :] <= idx[:, None], 0.0, -1e30)
            out = sdpa_attention(q, k, v, bias=bias.float()[None, None])
        else:
            out = chunked_attention(q, k, v,
                                    block_bias_fn=frame_causal_block_bias(n_hw),
                                    q_chunk=min(l, 2048), k_chunk=min(l, 2048))
        out = self.to_out[0](out) + seq
        return out.reshape(b, t, hh, ww, c)


def _flag(flags: Sequence[bool], j: int) -> bool:
    return j < len(flags) and bool(flags[j])


class MidBlock(nn.Module):
    """resnet0, then (attention, resnet), with optional temporal pooling
    before and after each resnet (reference:
    unet_causal_3d_blocks.py:647-678)."""

    def __init__(self, c: int, cfg: VAEConfig, **fk):
        super().__init__()
        g = cfg.norm_num_groups
        self.resnets = nn.ModuleList([ResnetBlock(c, c, g, **fk),
                                      ResnetBlock(c, c, g, **fk)])
        self.attentions = (nn.ModuleList([MidAttention(c, g, **fk)])
                           if cfg.mid_block_add_attention else None)

    def forward(self, x, tops_mid: Optional[MidBlockTOps] = None):
        for i, rn in enumerate(self.resnets):
            if i > 0 and self.attentions is not None:
                x = self.attentions[i - 1](x)
            x = self._pool(x, tops_mid, "before", i)
            x = rn(x)
            x = self._pool(x, tops_mid, "after", i)
        return x

    @staticmethod
    def _pool(x, conf: Optional[MidBlockTOps], where: str, i: int):
        if conf is not None and _flag(
                getattr(conf, f"enable_t_pool_{where}_block"), i):
            x = causal_avg_pool_t(x, conf.pool_t_kernel, conf.pool_t_stride)
        return x


class Sampler(nn.Module):
    """Key `<name>.conv.conv` (down/upsampler wrapping a CausalConv3d)."""

    def __init__(self, c: int, stride=(1, 1, 1), **fk):
        super().__init__()
        self.conv = CausalConv3d(c, c, stride=stride, **fk)


class DownBlock(nn.Module):
    def __init__(self, cin, cout, n, groups, stride, **fk):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(cin if j == 0 else cout, cout, groups, **fk)
            for j in range(n))
        self.downsamplers = (nn.ModuleList([Sampler(cout, stride, **fk)])
                             if stride is not None else None)


class UpBlock(nn.Module):
    def __init__(self, cin, cout, n, groups, factor, **fk):
        super().__init__()
        self.factor = factor
        self.resnets = nn.ModuleList(
            ResnetBlock(cin if j == 0 else cout, cout, groups, **fk)
            for j in range(n))
        self.upsamplers = (nn.ModuleList([Sampler(cout, **fk)])
                           if factor is not None else None)


class Encoder(nn.Module):
    """[B, T, H, W, 3] -> moments (reference: vae.py:118-136)."""

    def __init__(self, cfg: VAEConfig, **fk):
        super().__init__()
        bo, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = CausalConv3d(cfg.in_channels, bo[0], **fk)
        self.down_blocks = nn.ModuleList(
            DownBlock(*cfg.encoder_block_channels(i), cfg.layers_per_block, g,
                      cfg.downsample_stride(i), **fk)
            for i in range(cfg.num_blocks))
        self.mid_block = MidBlock(bo[-1], cfg, **fk)
        self.conv_norm_out = GroupNorm(g, bo[-1], **fk)
        self.conv_out = CausalConv3d(bo[-1], 2 * cfg.latent_channels, **fk)

    def forward(self, x, tops: Optional[TOpsConfig] = None):
        x = self.conv_in(x)
        for i, blk in enumerate(self.down_blocks):
            bt = tops.down(i) if tops is not None else None
            for j, rn in enumerate(blk.resnets):
                if bt is not None and _flag(bt.enable_t_pool_before_block, j):
                    x = causal_avg_pool_t(x, bt.pool_t_kernel,
                                          bt.pool_t_stride)
                x = rn(x)
                if bt is not None and _flag(bt.enable_t_pool_after_block, j):
                    x = causal_avg_pool_t(x, bt.pool_t_kernel,
                                          bt.pool_t_stride)
            if blk.downsamplers is not None:
                x = blk.downsamplers[0].conv(
                    x, stride=bt.downsample_stride if bt is not None else None)
        x = self.mid_block(x, tops.encoder_mid_block if tops is not None
                           else None)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    """Latent [B, T', h, w, C] -> [B, T, H, W, 3] (reference: vae.py:230-294)."""

    def __init__(self, cfg: VAEConfig, **fk):
        super().__init__()
        bo, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = CausalConv3d(cfg.latent_channels, bo[-1], **fk)
        self.mid_block = MidBlock(bo[-1], cfg, **fk)
        self.up_blocks = nn.ModuleList(
            UpBlock(*cfg.decoder_block_channels(i), cfg.layers_per_block + 1,
                    g, cfg.upsample_factor(i), **fk)
            for i in range(cfg.num_blocks))
        self.conv_norm_out = GroupNorm(g, bo[0], **fk)
        self.conv_out = CausalConv3d(bo[0], cfg.out_channels, **fk)

    def forward(self, z, tops: Optional[TOpsConfig] = None):
        x = self.mid_block(self.conv_in(z), tops.decoder_mid_block
                           if tops is not None else None)
        for i, blk in enumerate(self.up_blocks):
            bt = tops.up(i) if tops is not None else None
            for j, rn in enumerate(blk.resnets):
                if bt is not None and _flag(bt.enable_t_interp_before_block,
                                            j):
                    x = interpolate_nearest_t(x, bt.interp_t_scale_factor)
                x = rn(x)
                if bt is not None and _flag(bt.enable_t_interp_after_block, j):
                    x = interpolate_nearest_t(x, bt.interp_t_scale_factor)
            if blk.upsamplers is not None:
                x = blk.upsamplers[0].conv(
                    upsample_nearest_causal_3d(x, blk.factor))
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class DiagonalGaussian:
    """Channels-last moments [..., 2C] split into mean / logvar
    (reference: vae.py:297-358)."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=-1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        noise = torch.randn(self.mean.shape, generator=generator,
                            device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: Optional["DiagonalGaussian"] = None) -> torch.Tensor:
        """KL divergence to `other`, or to N(0, I); summed over all but the
        batch axis."""
        dims = tuple(range(1, self.mean.ndim))
        if other is None:
            return 0.5 * torch.sum(self.mean ** 2 + self.var - 1.0
                                   - self.logvar, dim=dims)
        return 0.5 * torch.sum(
            (self.mean - other.mean) ** 2 / other.var
            + self.var / other.var - 1.0 - self.logvar + other.logvar,
            dim=dims)

    def nll(self, sample: torch.Tensor, axes=(1, 2, 3)) -> torch.Tensor:
        logtwopi = math.log(2.0 * math.pi)
        return 0.5 * torch.sum(logtwopi + self.logvar
                               + (sample - self.mean) ** 2 / self.var,
                               dim=tuple(axes))


def _blend(a: torch.Tensor, b: torch.Tensor, extent: int, dim: int
           ) -> torch.Tensor:
    """Crossfade a's trailing `extent` slices into b's leading ones along
    `dim` (reference blend_v/h/t: autoencoder_kl_causal_3d.py:344-360)."""
    extent = min(a.shape[dim], b.shape[dim], extent)
    if extent == 0:
        return b
    shape = [1] * b.ndim
    shape[dim] = extent
    ramp = (torch.arange(extent, dtype=torch.float32, device=b.device)
            / extent).reshape(shape).to(b.dtype)
    a_tail = a.narrow(dim, a.shape[dim] - extent, extent)
    b_head = b.narrow(dim, 0, extent)
    blended = a_tail * (1 - ramp) + b_head * ramp
    return torch.cat([blended, b.narrow(dim, extent, b.shape[dim] - extent)],
                     dim=dim)


def _spatial_tiled(x: torch.Tensor, fn: Callable, in_tile: int,
                   out_tile: int, overlap_factor: float) -> torch.Tensor:
    """Run fn over overlapping spatial tiles of channels-last x and blend
    (reference: autoencoder_kl_causal_3d.py:362-469)."""
    overlap = int(in_tile * (1 - overlap_factor))
    blend = int(out_tile * overlap_factor)
    limit = out_tile - blend
    rows = [[fn(x[:, :, i:i + in_tile, j:j + in_tile])
             for j in range(0, x.shape[3], overlap)]
            for i in range(0, x.shape[2], overlap)]
    out_rows = []
    for i, row in enumerate(rows):
        out_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = _blend(rows[i - 1][j], tile, blend, dim=2)
            if j > 0:
                tile = _blend(row[j - 1], tile, blend, dim=3)
            out_row.append(tile[:, :, :limit, :limit])
        out_rows.append(torch.cat(out_row, dim=3))
    return torch.cat(out_rows, dim=2)


def _temporal_tiled(x: torch.Tensor, fn: Callable, in_tile: int,
                    out_tile: int, overlap_factor: float) -> torch.Tensor:
    """Run fn over overlapping causal temporal tiles (in_tile + 1 frames)
    and blend (reference: autoencoder_kl_causal_3d.py:471-541)."""
    overlap = int(in_tile * (1 - overlap_factor))
    blend = int(out_tile * overlap_factor)
    limit = out_tile - blend
    tiles = []
    for i in range(0, x.shape[1], overlap):
        y = fn(x[:, i:i + in_tile + 1])
        tiles.append(y[:, 1:] if i > 0 else y)
    out = []
    for i, tile in enumerate(tiles):
        if i > 0:
            out.append(_blend(tiles[i - 1], tile, blend, dim=1)[:, :limit])
        else:
            out.append(tile[:, :limit + 1])
    return torch.cat(out, dim=1)


class AutoencoderKLCausal3D(nn.Module):
    """encode / decode with optional spatial and temporal tiling; public
    tensors are [B, C, T, H, W] (reference:
    autoencoder_kl_causal_3d.py:135-214, 259-342, 543-578)."""

    def __init__(self, cfg: VAEConfig, tops: Optional[TOpsConfig] = None,
                 device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.tops = tops
        lc = cfg.latent_channels
        self.encoder = Encoder(cfg, **fk)
        self.decoder = Decoder(cfg, **fk)
        self.quant_conv = nn.Conv3d(2 * lc, 2 * lc, 1, **fk)
        self.post_quant_conv = nn.Conv3d(lc, lc, 1, **fk)
        self.use_slicing = False
        self.use_spatial_tiling = False
        self.use_temporal_tiling = False

    def enable_spatial_tiling(self, on: bool = True):
        self.use_spatial_tiling = on

    def enable_temporal_tiling(self, on: bool = True):
        self.use_temporal_tiling = on

    def enable_tiling(self, on: bool = True):
        self.enable_spatial_tiling(on)
        self.enable_temporal_tiling(on)

    def disable_tiling(self):
        self.enable_tiling(False)

    def enable_slicing(self, on: bool = True):
        """Encode and decode a batch one sample at a time."""
        self.use_slicing = on

    @property
    def dtype(self):
        return self.post_quant_conv.weight.dtype

    @staticmethod
    def _pointwise(conv: nn.Conv3d, x):
        w = conv.weight
        return conv3d_1x1(x, w.reshape(w.shape[0], w.shape[1]).t(), conv.bias)

    def _encode_tile(self, x):
        return self._pointwise(self.quant_conv,
                               self.encoder(x.to(self.dtype), self.tops))

    def _decode_tile(self, z):
        return self.decoder(self._pointwise(self.post_quant_conv,
                                            z.to(self.dtype)), self.tops)

    def _encode_spatial(self, x):
        cfg = self.cfg
        if self.use_spatial_tiling and max(x.shape[2:4]) > \
                cfg.tile_sample_min_size:
            return _spatial_tiled(x, self._encode_tile,
                                  cfg.tile_sample_min_size,
                                  cfg.tile_latent_min_size,
                                  cfg.tile_overlap_factor)
        return self._encode_tile(x)

    def _decode_spatial(self, z):
        cfg = self.cfg
        if self.use_spatial_tiling and max(z.shape[2:4]) > \
                cfg.tile_latent_min_size:
            return _spatial_tiled(z, self._decode_tile,
                                  cfg.tile_latent_min_size,
                                  cfg.tile_sample_min_size,
                                  cfg.tile_overlap_factor)
        return self._decode_tile(z)

    @torch.no_grad()
    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, T, H, W] -> moments [B, 2*latent, T', H', W']."""
        cfg = self.cfg
        xl = x.permute(0, 2, 3, 4, 1)
        if self.use_temporal_tiling and xl.shape[1] > cfg.tile_sample_min_tsize:
            m = _temporal_tiled(xl, self._encode_spatial,
                                cfg.tile_sample_min_tsize,
                                cfg.tile_latent_min_tsize,
                                cfg.tile_overlap_factor)
        else:
            m = self._encode_spatial(xl)
        return m.permute(0, 4, 1, 2, 3)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        if self.use_slicing and x.shape[0] > 1:
            moments = torch.cat([self.encode_moments(xs)
                                 for xs in x.split(1)])
        else:
            moments = self.encode_moments(x)
        return DiagonalGaussian(moments.movedim(1, -1))

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[B, latent, T', H', W'] -> [B, 3, T, H, W]."""
        cfg = self.cfg

        def one(zb):
            zl = zb.permute(0, 2, 3, 4, 1)
            if self.use_temporal_tiling and \
                    zl.shape[1] > cfg.tile_latent_min_tsize:
                d = _temporal_tiled(zl, self._decode_spatial,
                                    cfg.tile_latent_min_tsize,
                                    cfg.tile_sample_min_tsize,
                                    cfg.tile_overlap_factor)
            else:
                d = self._decode_spatial(zl)
            return d.permute(0, 4, 1, 2, 3)

        if self.use_slicing and z.shape[0] > 1:
            return torch.cat([one(zs) for zs in z.split(1)])
        return one(z)

    def forward(self, sample: torch.Tensor, sample_posterior: bool = False,
                generator: Optional[torch.Generator] = None,
                return_posterior: bool = False):
        """Round trip [B, C, T, H, W] -> encode -> the posterior's mode (or
        a sample drawn with `generator`) -> decode (reference:
        autoencoder_kl_causal_3d.py:543-578)."""
        posterior = self.encode(sample)
        if sample_posterior:
            if generator is None:
                raise ValueError("sampling the posterior needs a "
                                 "torch.Generator")
            z = posterior.sample(generator)
        else:
            z = posterior.mode()
        dec = self.decode(z.movedim(-1, 1))
        return (dec, posterior) if return_posterior else dec

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator
                     ) -> "AutoencoderKLCausal3D":
        """Random weights as the JAX init_vae_params draws them: convs and
        linears N(0, 1/fan_in), zero biases, unit norm scales."""
        for mod in self.modules():
            if isinstance(mod, (nn.Conv3d, nn.Linear)):
                w = mod.weight
                w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()),
                          generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        return self


def build_vae(cfg: VAEConfig, device="cuda", dtype=torch.float16,
              generator: Optional[torch.Generator] = None,
              tops: Optional[TOpsConfig] = None) -> AutoencoderKLCausal3D:
    """A VAE with storage on `device` and the t-ops config `tops`; random
    weights from `generator` when given, else uninitialized (to be filled
    by load_state_dict)."""
    with torch.device("meta"):
        vae = AutoencoderKLCausal3D(cfg, tops, dtype=dtype)
    vae = vae.to_empty(device=device).eval().requires_grad_(False)
    if generator is not None:
        vae.init_weights(generator)
    return vae
