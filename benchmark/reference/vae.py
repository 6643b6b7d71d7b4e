"""Plain reference of HunyuanVideo's causal-3D VAE round trip (884-16c-hy)
under the fork's temporal-ops (t-ops) configs, in float32 (TF32 off).

Follows the published VAE (hyvideo/vae/autoencoder_kl_causal_3d.py,
vae.py, unet_causal_3d_blocks.py): causal convs pad T by (k-1, 0) and H, W
by k//2 on both sides with the edge value; GroupNorm(32, eps 1e-6) and SiLU
before each conv of a resnet; a single-head frame-causal attention in each
mid block; the posterior's mode (the first half of the moments) is decoded.
The t-ops hooks (the fork's t_ops_config.json schema, its
unet_causal_3d_blocks.py hooks): causal average pooling over T before or
after an encoder resnet (pad k-1 frames at the front with the first one,
average k frames with stride s), a downsampler stride override, and
nearest interpolation over T before or after a decoder resnet.

`tier` names the control: every conv, linear and attention operand
rounded to bfloat16 ("bf16": 7 mantissa bits against fp16's 10, the
nearest precision below the configuration's fp16) or to float8_e4m3
("fp8", per-tensor scale), the sums in float32.

`shapes=[]` records each stride-1 3x3x3 conv with 128+ input and output
channels as (B, T, H, W, Cin, Cout); on meta tensors this lists a round
trip's launches of such convs without computing them.

Imports nothing of the program; the weights come from benchmark/weights.py.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .. import weights
from .dit import fp8 as fp8_round

# the operands' rounding of each tier, back in float32
ROUND = {None: lambda x: x,
         "bf16": lambda x: x.to(torch.bfloat16).float(),
         "fp8": fp8_round}


class VAE:
    def __init__(self, sd: Dict[str, torch.Tensor], cfg: dict,
                 tier: Optional[str] = None, shapes: Optional[list] = None):
        if tier not in ROUND:
            raise ValueError(f"no operand tier {tier!r}: one of {list(ROUND)}")
        self.sd = {k: v.float() for k, v in sd.items()}
        self.cfg = cfg
        self._q = ROUND[tier]
        self.shapes = shapes
        self.groups = cfg["norm_num_groups"]

    def conv(self, name: str, x: torch.Tensor, stride=(1, 1, 1)):
        """Causal conv of [B, C, T, H, W]."""
        w, b = self.sd[f"{name}.weight"], self.sd[f"{name}.bias"]
        k = w.shape[2]
        if k > 1:
            x = F.pad(x, (k // 2, k // 2, k // 2, k // 2, k - 1, 0),
                      mode="replicate")
        if self.shapes is not None and k == 3 and tuple(stride) == (1, 1, 1) \
                and w.shape[0] % 128 == 0 and w.shape[1] % 128 == 0:
            bb, c, t, h, ww = x.shape
            self.shapes.append((bb, t - 2, h - 2, ww - 2, c, w.shape[0]))
        return F.conv3d(self._q(x), self._q(w), b, stride=tuple(stride))

    def norm(self, name, x):
        return F.group_norm(x, self.groups, self.sd[f"{name}.weight"],
                            self.sd[f"{name}.bias"], 1e-6)

    def resnet(self, name, x):
        h = self.conv(f"{name}.conv1.conv", F.silu(self.norm(f"{name}.norm1",
                                                             x)))
        h = self.conv(f"{name}.conv2.conv", F.silu(self.norm(f"{name}.norm2",
                                                             h)))
        if f"{name}.conv_shortcut.conv.weight" in self.sd:
            x = self.conv(f"{name}.conv_shortcut.conv", x)
        return x + h

    def attention(self, name, x, q_chunk: int = 4096):
        """Single-head attention over all T*H*W positions, position i
        seeing j iff frame(j) <= frame(i); residual."""
        b, c, t, h, w = x.shape
        n_hw = h * w
        seq = self.norm(f"{name}.group_norm", x).flatten(2).transpose(1, 2)

        def lin(p, v):
            return self._q(v) @ self._q(self.sd[f"{name}.{p}.weight"]).t() \
                + self.sd[f"{name}.{p}.bias"]

        q, k, v = lin("to_q", seq), lin("to_k", seq), lin("to_v", seq)
        if x.device.type == "meta":
            out = q
        else:
            frame = torch.arange(t * n_hw, device=x.device) // n_hw
            outs = []
            for i0 in range(0, t * n_hw, q_chunk):
                qi = q[:, i0:i0 + q_chunk]
                s = self._q(qi) @ self._q(k).transpose(1, 2) / c ** 0.5
                keep = frame[None, :] <= frame[i0:i0 + q_chunk, None]
                p = s.masked_fill(~keep, float("-inf")).softmax(-1)
                outs.append(self._q(p) @ self._q(v))
            out = torch.cat(outs, 1)
        out = lin("to_out.0", out)
        return x + out.transpose(1, 2).reshape(b, c, t, h, w)

    @staticmethod
    def _flag(flags, j):
        return j < len(flags) and bool(flags[j])

    def pool_t(self, x, k, s):
        x = F.pad(x, (0, 0, 0, 0, k - 1, 0), mode="replicate")
        return x.unfold(2, k, s).mean(-1)

    def mid(self, name, x, hooks: Optional[dict]):
        for i in range(2):
            if i > 0:
                x = self.attention(f"{name}.attentions.0", x)
            if hooks and self._flag(hooks["enable_t_pool_before_block"], i):
                x = self.pool_t(x, hooks["pool_t_kernel"],
                                hooks["pool_t_stride"])
            x = self.resnet(f"{name}.resnets.{i}", x)
            if hooks and self._flag(hooks["enable_t_pool_after_block"], i):
                x = self.pool_t(x, hooks["pool_t_kernel"],
                                hooks["pool_t_stride"])
        return x

    def encode(self, x, tops: Optional[dict]):
        """[B, 3, T, H, W] -> the posterior's mean [B, C, T', H', W']."""
        cfg = self.cfg
        enc = tops["encoder"] if tops else {}
        downs = enc.get("down_blocks", [])
        x = self.conv("encoder.conv_in.conv", x)
        for i in range(len(cfg["block_out_channels"])):
            hk = downs[i] if i < len(downs) else None
            for j in range(cfg["layers_per_block"]):
                if hk and self._flag(hk["enable_t_pool_before_block"], j):
                    x = self.pool_t(x, hk["pool_t_kernel"],
                                    hk["pool_t_stride"])
                x = self.resnet(f"encoder.down_blocks.{i}.resnets.{j}", x)
                if hk and self._flag(hk["enable_t_pool_after_block"], j):
                    x = self.pool_t(x, hk["pool_t_kernel"],
                                    hk["pool_t_stride"])
            stride = weights.vae_down_stride(cfg, i)
            if stride is not None:
                if hk and hk.get("downsample_stride"):
                    stride = hk["downsample_stride"]
                x = self.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv"
                              f".conv", x, stride)
        x = self.mid("encoder.mid_block", x, enc.get("mid_block"))
        x = self.conv("encoder.conv_out.conv",
                      F.silu(self.norm("encoder.conv_norm_out", x)))
        x = self.conv("quant_conv", x)
        return x[:, :cfg["latent_channels"]]

    def decode(self, z, tops: Optional[dict]):
        cfg = self.cfg
        dec = tops["decoder"] if tops else {}
        ups = dec.get("up_blocks", [])
        x = self.conv("decoder.conv_in.conv", self.conv("post_quant_conv", z))
        x = self.mid("decoder.mid_block", x, dec.get("mid_block"))
        for i in range(len(cfg["block_out_channels"])):
            hk = ups[i] if i < len(ups) else None
            for j in range(cfg["layers_per_block"] + 1):
                if hk and self._flag(hk["enable_t_interp_before_block"], j):
                    x = x.repeat_interleave(hk["interp_t_scale_factor"], 2)
                x = self.resnet(f"decoder.up_blocks.{i}.resnets.{j}", x)
                if hk and self._flag(hk["enable_t_interp_after_block"], j):
                    x = x.repeat_interleave(hk["interp_t_scale_factor"], 2)
            factor = weights.vae_down_stride(cfg, i)
            if factor is not None:
                x = self.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv.conv",
                              upsample_causal(x, factor))
        return self.conv("decoder.conv_out.conv",
                         F.silu(self.norm("decoder.conv_norm_out", x)))

    def roundtrip(self, x, tops: Optional[dict]):
        return self.decode(self.encode(x, tops), tops)


def upsample_causal(x, factor):
    """Nearest upsample of [B, C, T, H, W]: the first frame in H, W only,
    the others in T, H and W (T' = (T - 1) * ft + 1)."""
    ft, fh, fw = factor

    def hw(v):
        return v.repeat_interleave(fh, 3).repeat_interleave(fw, 4)

    first = hw(x[:, :, :1])
    if x.shape[2] == 1:
        return first
    return torch.cat([first, hw(x[:, :, 1:].repeat_interleave(ft, 2))], 2)


def load(cfg: dict, seed: int, device, dtype, tier: Optional[str] = None,
         shapes: Optional[list] = None) -> VAE:
    sd = {}
    for _, g in weights.state_dicts("vae", cfg, seed, device, dtype):
        sd.update(g)
    return VAE(sd, cfg, tier, shapes)


def k3_shapes(cfg: dict, tops: Optional[dict], frames: int, height: int,
              width: int) -> List[tuple]:
    """Every stride-1 3x3x3 conv with 128+ channels of one round trip, in
    order: (B, T, H, W, Cin, Cout) of its output, computed on meta
    tensors."""
    shapes = []
    vae = VAE({n: torch.empty(s, device="meta")
               for _, leaves in weights.vae_groups(cfg)
               for n, s, _ in leaves}, cfg, shapes=shapes)
    x = torch.empty(1, cfg["in_channels"], frames, height, width,
                    device="meta")
    vae.roundtrip(x, tops)
    return shapes
