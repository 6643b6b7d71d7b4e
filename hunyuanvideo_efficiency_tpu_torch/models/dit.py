"""HunyuanVideo MM-DiT backbone (JAX counterpart: models/dit.py; reference:
hyvideo/modules/models.py:396-760).

Module names follow the reference checkpoint's state-dict keys (the ones
the JAX package's utils/checkpoint.py:convert_dit_state_dict reads), so a
reference `.pt` loads with `load_state_dict` unchanged. The patch embedding
is a stride == kernel Conv3d (`img_in.proj`) applied as a reshape + matmul.

Joint attention over [img | txt] with a key-padding bias replaces varlen
packing; QK-RMSNorm + interleaved 3-axis RoPE; the single-stream block's
fused linear1 is split into its qkv columns and MLP columns, and linear2
into the attention rows (with the bias) and MLP rows, as in the JAX block.
With QK-norm the scores are bounded by `_analytic_score_bound`, and
attention runs the static-offset flash kernel (K1). QK-RMSNorm + RoPE of
each q/k pair is one launch of ops/rope.py:qk_norm_rope (`_qk_rope`):
per forward a double block's image and text pairs, and a single block's
joint [img | txt] pair (its table's text rows the identity), or its image
and text pairs apart on the split path.

Under attn_mode="sta" (and "sta_int8") the image queries run sliding-tile
attention over the (T', H', W') patch grid (ops/sta.py): the RoPE table
stays image-only, both block types split q/k/v into image and text parts
(norm + RoPE on the image part, norm only on the text part), and the first
`sta_dense_{double,single}_blocks` of each stack keep dense attention
(JAX models/dit.py:1003-1024). attn_mode="flash_int8" runs int8 Q.K^T flash
attention (ops/flash_attention.py:flash_attention_int8).

Sequence parallelism: `forward_tokens(..., sp=groups)` runs one rank's
token shard (parallel/sp_dit.py); both blocks' joint attention then goes
through `parallel.sp_attention.usp_joint_attention`, with image-only RoPE
rows (the split path, as JAX models/dit.py:880-900 under its axes).

The weight-sharded tier (`--shard-dit-weights`, parallel/weight_shard.py):
`weight_shards` holds the block stacks' shards, and `forward_tokens` has
each chunk of blocks gathered back to full size just before it runs (JAX
models/dit.py:991-1018, its `param_gather`).

Training: `forward_tokens` is the JAX `dit_forward_tokens` (raw patch tokens
in, output patch tokens out), `build_dit(trainable=True)` leaves the
parameters differentiable, and `cfg.remat_blocks` checkpoints every block
(torch.utils.checkpoint, the reentrant form: a block's first forward runs
without grad, i.e. through the LSE-free attention kernels, and is run again
with grad inside the backward pass).

Block linears may hold a weight tier (ops/quantization.py: fp8, int8, int4
modulation); every block linear goes through `quantization.linear`, so the
single block's column and row slices work for each tier, and under int8 the
MLP's activation fuses into fc1's W8A8 epilogue (JAX `mlp()`), while the
single block applies its activation to the stored output (JAX
models/dit.py:779-783).

Spans (utils/profiling.py:span, recorded only under a profiler):
`dit.embed` around a forward's conditioning and token embedders
(time_in, vector_in, guidance_in, img_in and txt_in), `dit.adaln` at each
adaLN input and gated residual of the blocks and the final layer,
`dit.qk_rope` around each block's QK-norm + RoPE, `dit.attention` around
each block's joint attention with its layout work.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import (attention, joint_attention, joint_key_bias,
                             sdpa_attention, text_key_bias)
from ..ops.norms import layer_norm, rms_norm
from ..ops.quantization import linear
from ..ops.rope import qk_norm_rope, rotate_tokens
from ..utils.profiling import span
from .dit_config import DiTConfig

ACT = {
    "gelu": F.gelu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
}


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding in [cos | sin] order, fp32
    (reference: embed_layers.py:93-117)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def modulate(x, shift, scale):
    return x * (1.0 + scale[:, None]) + shift[:, None]


def apply_gate(x, gate):
    return x * gate[:, None]


def _adaln(x, shift, scale):
    """A block's adaLN input, modulate(layer_norm(x)), in a `dit.adaln`
    span."""
    with span("dit.adaln"):
        return modulate(layer_norm(x), shift, scale)


def _gated(x, y, gate):
    """A block's gated residual, x + apply_gate(y, gate), in a `dit.adaln`
    span."""
    with span("dit.adaln"):
        return x + apply_gate(y, gate)


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden: int, freq_size: int = 256, **fk):
        super().__init__()
        self.freq_size = freq_size
        self.mlp = nn.Sequential(nn.Linear(freq_size, hidden, **fk), nn.SiLU(),
                                 nn.Linear(hidden, hidden, **fk))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        w = self.mlp[0].weight
        return self.mlp(timestep_embedding(t, self.freq_size).to(w.dtype))


class MLPEmbedder(nn.Module):
    """in_layer -> silu -> out_layer (reference: mlp_layers.py:63-73)."""

    def __init__(self, cin: int, hidden: int, **fk):
        super().__init__()
        self.in_layer = nn.Linear(cin, hidden, **fk)
        self.out_layer = nn.Linear(hidden, hidden, **fk)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class MLP(nn.Module):
    def __init__(self, cin: int, hidden: int, **fk):
        super().__init__()
        self.fc1 = nn.Linear(cin, hidden, **fk)
        self.fc2 = nn.Linear(hidden, cin, **fk)

    def forward(self, x, act: str, plain: bool = False):
        return linear(self.fc2, linear(self.fc1, x, act=act, plain=plain),
                      plain=plain)


class ModulateDiT(nn.Module):
    """silu -> linear; key `<name>.linear`."""

    def __init__(self, hidden: int, factor: int, **fk):
        super().__init__()
        self.linear = nn.Linear(hidden, factor * hidden, **fk)

    def forward(self, vec, plain: bool = False):
        return linear(self.linear, F.silu(vec), plain=plain)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, **fk):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, **fk))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, **fk):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, **fk))
        self.bias = nn.Parameter(torch.zeros(dim, **fk))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


def _qk_norm_layer(cfg: DiTConfig, d: int, **fk) -> nn.Module:
    return RMSNorm(d, **fk) if cfg.qk_norm_type == "rms" else LayerNorm(d, **fk)


def _qk_rope(cfg: DiTConfig, q_norm: nn.Module, k_norm: nn.Module, q, k,
             freqs, plain: bool):
    """QK-norm + RoPE of one q/k pair; tokens past the table's rows (all of
    them with freqs None) only normalized. QK-RMSNorm goes through
    ops/rope.py:qk_norm_rope: one kernel launch on CUDA tensors (which
    raises for those it does not take), its plain version on CPU tensors or
    with plain=True."""
    if not cfg.qk_norm:
        return (q, k) if freqs is None else (rotate_tokens(q, freqs),
                                             rotate_tokens(k, freqs))
    if cfg.qk_norm_type != "rms":
        if freqs is None:
            return q_norm(q), k_norm(k)
        return (rotate_tokens(q, freqs, pre=q_norm),
                rotate_tokens(k, freqs, pre=k_norm))
    return qk_norm_rope(q, k, q_norm.weight, k_norm.weight, freqs,
                        q_norm.eps, plain=plain)


# --------------------------------------------------------------------------
# Token refiner (reference: hyvideo/modules/token_refiner.py)
# --------------------------------------------------------------------------

class RefinerBlock(nn.Module):
    def __init__(self, h: int, heads: int, **fk):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm(h, **fk)
        self.self_attn_qkv = nn.Linear(h, 3 * h, **fk)
        self.self_attn_proj = nn.Linear(h, h, **fk)
        self.norm2 = LayerNorm(h, **fk)
        self.mlp = MLP(h, 4 * h, **fk)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              nn.Linear(h, 2 * h, **fk))

    def forward(self, x, c, attn_bias):
        gate_msa, gate_mlp = self.adaLN_modulation(c).chunk(2, dim=-1)
        qkv = self.self_attn_qkv(self.norm1(x))
        b, l, _ = qkv.shape
        q, k, v = (u.reshape(b, l, self.heads, -1)
                   for u in qkv.chunk(3, dim=-1))
        attn = sdpa_attention(q, k, v, bias=attn_bias)
        x = x + apply_gate(self.self_attn_proj(attn), gate_msa)
        return x + apply_gate(self.mlp(self.norm2(x), "silu"), gate_mlp)


class TextProjection(nn.Module):
    def __init__(self, cin: int, h: int, **fk):
        super().__init__()
        self.linear_1 = nn.Linear(cin, h, **fk)
        self.linear_2 = nn.Linear(h, h, **fk)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class RefinerBlocks(nn.Module):
    def __init__(self, depth: int, h: int, heads: int, **fk):
        super().__init__()
        self.blocks = nn.ModuleList(RefinerBlock(h, heads, **fk)
                                    for _ in range(depth))


class SingleTokenRefiner(nn.Module):
    """LLM hidden states [B, L, text_dim] -> refined [B, L, hidden]
    (reference: token_refiner.py:164-236)."""

    def __init__(self, cfg: DiTConfig, depth: int = 2, **fk):
        super().__init__()
        h, td = cfg.hidden_size, cfg.text_states_dim
        self.input_embedder = nn.Linear(td, h, **fk)
        self.t_embedder = TimestepEmbedder(h, **fk)
        self.c_embedder = TextProjection(td, h, **fk)
        self.individual_token_refiner = RefinerBlocks(depth, h, cfg.heads_num,
                                                      **fk)

    def forward(self, x, t, mask):
        t_emb = self.t_embedder(t)
        if mask is None:
            ctx = x.mean(dim=1)
        else:
            mf = mask.to(x.dtype)[..., None]
            ctx = (x * mf).sum(dim=1) / mf.sum(dim=1).clamp_min(1.0)
        c = t_emb + self.c_embedder(ctx)
        attn_bias = None
        if mask is not None:
            m = mask.bool()
            pair = m[:, None, :] & m[:, :, None]
            pair[:, :, 0] = True  # no all-masked rows (reference :157)
            attn_bias = torch.where(pair, 0.0, -1e30).float()[:, None]
        x = self.input_embedder(x)
        for blk in self.individual_token_refiner.blocks:
            x = blk(x, c, attn_bias)
        return x


# --------------------------------------------------------------------------
# MM blocks
# --------------------------------------------------------------------------

def _analytic_score_bound(cfg: DiTConfig, d: int, norm_pairs):
    """Weight-derived bound on |q.k|*scale after QK-norm + RoPE (JAX
    models/dit.py:331-364): ||norm(x)*g|| <= sqrt(d)*max|g| (+ the bias
    norm for LayerNorm), RoPE preserves row norms, so
    C = max_q_bound * max_k_bound / sqrt(d), times 1.02 for bf16 rounding,
    capped at 60. Returns a 0-d fp32 tensor, or None without QK-norm."""
    if not cfg.qk_norm:
        return None

    def row_bound(norm):
        bound = (d ** 0.5) * norm.weight.float().abs().max()
        if cfg.qk_norm_type != "rms":
            bound = bound + norm.bias.float().square().sum().sqrt()
        return bound

    with torch.no_grad():   # the bound only shifts an exponent offset
        qb = torch.stack([row_bound(nq) for nq, _ in norm_pairs]).max()
        kb = torch.stack([row_bound(nk) for _, nk in norm_pairs]).max()
        return torch.clamp(qb * kb * (d ** -0.5) * 1.02, max=60.0)


def _bound_mode(cfg: DiTConfig) -> str:
    """With QK-RMSNorm the analytic bound always holds: static kernel."""
    return "static" if cfg.qk_norm else "auto"


def _joint(cfg: DiTConfig, sp, *qkv, mode, sbound, token_grid, plain):
    """Joint attention of a block: on one device, or over the sp groups."""
    kw = dict(bound_mode=_bound_mode(cfg), score_bound=sbound,
              token_grid=token_grid, sta_tile=cfg.sta_tile,
              sta_window=cfg.sta_window, plain=plain)
    if sp is not None:
        from ..parallel.sp_attention import usp_joint_attention

        return usp_joint_attention(*qkv, sp, attn_mode=mode, **kw)
    return joint_attention(*qkv, mode=mode, **kw)


class DoubleBlock(nn.Module):
    """(reference: models.py:132-252)."""

    def __init__(self, cfg: DiTConfig, **fk):
        super().__init__()
        self.cfg = cfg
        h, d, m = cfg.hidden_size, cfg.head_dim, cfg.mlp_hidden_dim
        for s in ("img", "txt"):
            setattr(self, f"{s}_mod", ModulateDiT(h, 6, **fk))
            setattr(self, f"{s}_attn_qkv",
                    nn.Linear(h, 3 * h, bias=cfg.qkv_bias, **fk))
            setattr(self, f"{s}_attn_q_norm", _qk_norm_layer(cfg, d, **fk))
            setattr(self, f"{s}_attn_k_norm", _qk_norm_layer(cfg, d, **fk))
            setattr(self, f"{s}_attn_proj",
                    nn.Linear(h, h, bias=cfg.qkv_bias, **fk))
            setattr(self, f"{s}_mlp", MLP(h, m, **fk))

    def _qkv(self, s: str, x, plain: bool):
        cfg = self.cfg
        b, l, _ = x.shape
        qkv = linear(getattr(self, f"{s}_attn_qkv"), x, plain=plain)
        q, k, v = (u.reshape(b, l, cfg.heads_num, cfg.head_dim)
                   for u in qkv.chunk(3, -1))
        return q, k, v

    def forward(self, img, txt, vec, txt_bias, freqs_cis, token_grid=None,
                attn_mode: Optional[str] = None, plain: bool = False,
                sp=None):
        """attn_mode overrides cfg.attn_mode (the dense anchors under STA);
        token_grid reaches joint_attention; plain=True runs the W8A8, int8
        attention and STA image queries on their plain versions; sp (the
        rank's SPGroups) sends the attention over the sp groups."""
        cfg = self.cfg
        b, img_len, _ = img.shape
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = self.img_mod(
            vec, plain).chunk(6, -1)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = self.txt_mod(
            vec, plain).chunk(6, -1)
        img_m = _adaln(img, i_sh1, i_sc1)
        txt_m = _adaln(txt, t_sh1, t_sc1)

        img_q, img_k, img_v = self._qkv("img", img_m, plain)
        txt_q, txt_k, txt_v = self._qkv("txt", txt_m, plain)
        with span("dit.qk_rope"):
            # img rows of the joint table (its text rows are the identity);
            # the text pair is only normalized
            img_freqs = None if freqs_cis is None else (
                freqs_cis[0][:img_len], freqs_cis[1][:img_len])
            img_q, img_k = _qk_rope(cfg, self.img_attn_q_norm,
                                    self.img_attn_k_norm, img_q, img_k,
                                    img_freqs, plain)
            txt_q, txt_k = _qk_rope(cfg, self.txt_attn_q_norm,
                                    self.txt_attn_k_norm, txt_q, txt_k, None,
                                    plain)

        sbound = _analytic_score_bound(
            cfg, cfg.head_dim,
            [(self.img_attn_q_norm, self.img_attn_k_norm),
             (self.txt_attn_q_norm, self.txt_attn_k_norm)])
        with span("dit.attention"):
            img_attn, txt_attn = _joint(
                cfg, sp, img_q, img_k, img_v, txt_q, txt_k, txt_v, txt_bias,
                mode=attn_mode or cfg.attn_mode, sbound=sbound,
                token_grid=token_grid, plain=plain)

        img = _gated(img, linear(self.img_attn_proj, img_attn, plain=plain),
                     i_g1)
        img = _gated(img, self.img_mlp(_adaln(img, i_sh2, i_sc2),
                                       cfg.mlp_act_type, plain), i_g2)
        txt = _gated(txt, linear(self.txt_attn_proj, txt_attn, plain=plain),
                     t_g1)
        txt = _gated(txt, self.txt_mlp(_adaln(txt, t_sh2, t_sc2),
                                       cfg.mlp_act_type, plain), t_g2)
        return img, txt


class SingleBlock(nn.Module):
    """Parallel attention + MLP block with fused linears (reference:
    models.py:326-393): out = attn @ W2[:, :h]^T + b2
    + act(x_mod @ W1[3h:]^T + b1[3h:]) @ W2[:, h:]^T, the column/row split
    of the JAX block (no [L, 3h+m] or [L, h+m] concatenation)."""

    def __init__(self, cfg: DiTConfig, **fk):
        super().__init__()
        self.cfg = cfg
        h, d, m = cfg.hidden_size, cfg.head_dim, cfg.mlp_hidden_dim
        self.linear1 = nn.Linear(h, 3 * h + m, **fk)
        self.linear2 = nn.Linear(h + m, h, **fk)
        self.q_norm = _qk_norm_layer(cfg, d, **fk)
        self.k_norm = _qk_norm_layer(cfg, d, **fk)
        self.modulation = ModulateDiT(h, 3, **fk)

    def forward(self, x, vec, txt_len: int, txt_bias, freqs_cis,
                token_grid=None, attn_mode: Optional[str] = None,
                plain: bool = False, sp=None):
        """As DoubleBlock.forward for attn_mode, token_grid, plain and sp.
        A joint [img | txt] RoPE table rotates q/k in place; an image-only
        table (STA, sp) takes the split path of JAX models/dit.py:758-778."""
        cfg = self.cfg
        mode = attn_mode or cfg.attn_mode
        b, l, h = x.shape
        h3 = 3 * h
        shift, scale, gate = self.modulation(vec, plain).chunk(3, -1)
        x_mod = _adaln(x, shift, scale)
        qkv = linear(self.linear1, x_mod, out=slice(0, h3), plain=plain)
        q, k, v = (u.reshape(b, l, cfg.heads_num, cfg.head_dim)
                   for u in qkv.chunk(3, -1))
        sbound = _analytic_score_bound(cfg, cfg.head_dim,
                                       [(self.q_norm, self.k_norm)])
        img_len = l - txt_len
        if sp is not None or mode.startswith("sta") or (
                freqs_cis is not None and freqs_cis[0].shape[0] != l):
            iq, ik, iv = (u[:, :img_len] for u in (q, k, v))
            tq, tk, tv = (u[:, img_len:] for u in (q, k, v))
            with span("dit.qk_rope"):
                iq, ik = _qk_rope(cfg, self.q_norm, self.k_norm, iq, ik,
                                  freqs_cis, plain)
                tq, tk = _qk_rope(cfg, self.q_norm, self.k_norm, tq, tk,
                                  None, plain)
            with span("dit.attention"):
                img_attn, txt_attn = _joint(
                    cfg, sp, iq, ik, iv, tq, tk, tv, txt_bias, mode=mode,
                    sbound=sbound, token_grid=token_grid, plain=plain)
                attn = torch.cat([img_attn, txt_attn], dim=1)
        else:
            with span("dit.qk_rope"):
                # the joint table: its text rows are the identity
                q, k = _qk_rope(cfg, self.q_norm, self.k_norm, q, k,
                                freqs_cis, plain)
            with span("dit.attention"):
                attn = attention(q, k, v, mode=mode,
                                 key_bias=joint_key_bias(txt_bias, img_len),
                                 bound_mode=_bound_mode(cfg),
                                 score_bound=sbound, plain=plain)
        out = linear(self.linear2, attn, in_=slice(0, h), plain=plain)
        hid = ACT[cfg.mlp_act_type](
            linear(self.linear1, x_mod, out=slice(h3, None), plain=plain))
        out = out + linear(self.linear2, hid, in_=slice(h, None), bias=False,
                           plain=plain)
        return _gated(x, out, gate)


class PatchEmbed(nn.Module):
    """Conv3d with kernel == stride == patch, applied to raw patch tokens as
    a matmul (reference: embed_layers.py:40-58)."""

    def __init__(self, patch, cin: int, hidden: int, **fk):
        super().__init__()
        self.proj = nn.Conv3d(cin, hidden, kernel_size=patch, stride=patch,
                              **fk)

    def forward(self, tokens):
        w = self.proj.weight
        return F.linear(tokens.to(w.dtype), w.reshape(w.shape[0], -1),
                        self.proj.bias)


class FinalLayer(nn.Module):
    """Norm-free adaLN + linear (reference: mlp_layers.py:114-118)."""

    def __init__(self, h: int, out: int, **fk):
        super().__init__()
        self.linear = nn.Linear(h, out, **fk)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              nn.Linear(h, 2 * h, **fk))

    def forward(self, img, vec):
        shift, scale = self.adaLN_modulation(vec).chunk(2, -1)
        return self.linear(_adaln(img, shift, scale))


def patchify_raw(x: torch.Tensor, patch: Tuple[int, int, int]) -> torch.Tensor:
    """[B, C, T, H, W] -> raw patch tokens [B, T'H'W', C*pt*ph*pw], tokens in
    row-major (t, h, w) order, features in the conv kernel's (C, pt, ph, pw)
    order."""
    b, c, t, hh, ww = x.shape
    pt, ph, pw = patch
    x = x.reshape(b, c, t // pt, pt, hh // ph, ph, ww // pw, pw)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (t // pt) * (hh // ph) * (ww // pw), c * pt * ph * pw)


def unpatchify(x: torch.Tensor, tt: int, th: int, tw: int, c: int,
               patch: Tuple[int, int, int]) -> torch.Tensor:
    """Tokens [B, L, pt*ph*pw*C] -> [B, C, T, H, W]
    (reference: models.py:697-710, einsum 'nthwcopq->nctohpwq')."""
    pt, ph, pw = patch
    b = x.shape[0]
    x = x.reshape(b, tt, th, tw, c, pt, ph, pw)
    x = torch.einsum("nthwcopq->nctohpwq", x)
    return x.reshape(b, c, tt * pt, th * ph, tw * pw)


class HYVideoDiT(nn.Module):
    """The full MM-DiT; `forward` is the JAX `dit_forward`."""

    def __init__(self, cfg: DiTConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        h = cfg.hidden_size
        pt, ph, pw = cfg.patch_size
        self.img_in = PatchEmbed(cfg.patch_size, cfg.in_channels, h, **fk)
        self.time_in = TimestepEmbedder(h, **fk)
        self.vector_in = MLPEmbedder(cfg.text_states_dim_2, h, **fk)
        if cfg.guidance_embed:
            self.guidance_in = TimestepEmbedder(h, **fk)
        if cfg.text_projection == "single_refiner":
            self.txt_in = SingleTokenRefiner(cfg, **fk)
        elif cfg.text_projection == "linear":
            self.txt_in = TextProjection(cfg.text_states_dim, h, **fk)
        else:
            raise NotImplementedError(cfg.text_projection)
        self.double_blocks = nn.ModuleList(
            DoubleBlock(cfg, **fk) for _ in range(cfg.mm_double_blocks_depth))
        self.single_blocks = nn.ModuleList(
            SingleBlock(cfg, **fk) for _ in range(cfg.mm_single_blocks_depth))
        self.final_layer = FinalLayer(h, pt * ph * pw * cfg.out_channels, **fk)
        # the block stacks' weight shards (parallel/weight_shard.py), or None
        self.weight_shards = None

    def forward(self, x, t, text_states, text_mask, text_states_2,
                freqs_cos, freqs_sin, guidance=None, plain: bool = False):
        """x [B, C, T', H', W'] latent, t [B] in [0, 1000), text_states
        [B, L, text_dim], text_mask [B, L], text_states_2 [B, text_dim_2],
        freqs [img_len, head_dim] -> [B, C, T', H', W']
        (reference: models.py:595-695). plain=True runs the int8 linears,
        the int8 attention and the STA image queries through their plain
        versions instead of the kernels (a reference for checks on the
        card; no inference path sets it)."""
        cfg = self.cfg
        _, _, ot, oh, ow = x.shape
        pt, ph, pw = cfg.patch_size
        tt, th, tw = ot // pt, oh // ph, ow // pw
        out = self.forward_tokens(
            patchify_raw(x, cfg.patch_size), t, text_states, text_mask,
            text_states_2, freqs_cos, freqs_sin, guidance,
            token_grid=(tt, th, tw), plain=plain)
        return unpatchify(out, tt, th, tw, cfg.out_channels, cfg.patch_size)

    def forward_tokens(self, x_tokens, t, text_states, text_mask,
                       text_states_2, freqs_cos, freqs_sin, guidance=None,
                       token_grid=None, plain: bool = False, sp=None):
        """Token-form forward (JAX `dit_forward_tokens`): raw patch tokens
        [B, L, C*pt*ph*pw] in, output patch tokens [B, L, pt*ph*pw*out_c]
        out; the other arguments as `forward`. token_grid is the (T', H',
        W') patch grid, needed under attn_mode "sta". With
        cfg.remat_blocks and grad mode on, every block is checkpointed.
        With sp (the rank's SPGroups), x_tokens and the RoPE rows are this
        rank's token shard and token_grid the GLOBAL grid."""
        cfg = self.cfg
        dtype = self.img_in.proj.weight.dtype

        if cfg.guidance_embed and guidance is None:
            raise ValueError("guidance required for guidance-distilled "
                             "model")
        with span("dit.embed"):
            vec = self.time_in(t) + self.vector_in(text_states_2.to(dtype))
            if cfg.guidance_embed:
                vec = vec + self.guidance_in(guidance)
            img = self.img_in(x_tokens)
            text_states = text_states.to(dtype)
            if cfg.text_projection == "linear":
                txt = self.txt_in(text_states)
            else:
                txt = self.txt_in(text_states, t, text_mask
                                  if cfg.use_attention_mask else None)
        img_len = img.shape[1]
        txt_len = txt.shape[1]
        txt_bias = text_key_bias(text_mask) if text_mask is not None else None

        sta = cfg.attn_mode.startswith("sta")
        freqs = None
        if freqs_cos is not None and (sta or sp is not None):
            freqs = (freqs_cos, freqs_sin)  # image-only: blocks split
        elif freqs_cos is not None:
            # identity rows (cos 1, sin 0) over the text segment: the joint
            # [img | txt] q/k rotate in place
            fd = freqs_cos.shape[-1]
            freqs = (torch.cat([freqs_cos, freqs_cos.new_ones(txt_len, fd)]),
                     torch.cat([freqs_sin, freqs_sin.new_zeros(txt_len, fd)]))
        remat = cfg.remat_blocks and torch.is_grad_enabled()

        def run(blk, n_dense, i, *xs):
            mode = "auto" if sta and i < n_dense else None

            # every differentiable input (the streams and vec) is an
            # argument: the reentrant checkpoint returns gradients only for
            # its tensor arguments
            def fn(v, *ys):
                if len(ys) == 2:
                    return blk(*ys, v, txt_bias, freqs, token_grid, mode,
                               plain, sp)
                return blk(*ys, v, txt_len, txt_bias, freqs, token_grid,
                           mode, plain, sp)

            if remat:
                return checkpoint(fn, vec, *xs, use_reentrant=True,
                                  preserve_rng_state=False)
            return fn(vec, *xs)

        shards = self.weight_shards
        for i, blk in enumerate(self.double_blocks):
            if shards is not None:
                shards.fetch("double_blocks", i)
            img, txt = run(blk, cfg.sta_dense_double_blocks, i, img, txt)
        xx = torch.cat([img, txt], dim=1)
        for i, blk in enumerate(self.single_blocks):
            if shards is not None:
                shards.fetch("single_blocks", i)
            xx = run(blk, cfg.sta_dense_single_blocks, i, xx)
        return self.final_layer(xx[:, :img_len], vec)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "HYVideoDiT":
        """Random weights as the JAX init_dit_params draws them: linears
        uniform(+-1/sqrt(fan_in)), timestep-embedder linears N(0, 0.02),
        zero biases, unit norm scales, and zero adaLN modulation and final
        layers (so every block starts as the identity)."""
        for name, mod in self.named_modules():
            init_module(name, mod, generator)
        return self


@torch.no_grad()
def init_module(name: str, mod: nn.Module, generator: torch.Generator
                ) -> None:
    """HYVideoDiT.init_weights's draw for the one module `mod` (not its
    children) of dotted name `name` in the model: called in the model's
    module order, the same values."""
    if isinstance(mod, (nn.Linear, nn.Conv3d)):
        w = mod.weight
        fan_in = w[0].numel()
        if (name.startswith("final_layer.") or name.endswith("_mod.linear")
                or name.endswith("modulation.linear")
                or name.endswith("adaLN_modulation.1")):
            w.zero_()
        elif ".mlp." in f".{name}" and ("t_embedder" in name
                                        or name.startswith("time_in")
                                        or name.startswith("guidance_in")):
            w.normal_(0.0, 0.02, generator=generator)
        else:
            bound = 1.0 / math.sqrt(fan_in)
            w.uniform_(-bound, bound, generator=generator)
        if mod.bias is not None:
            mod.bias.zero_()
    elif isinstance(mod, (RMSNorm, LayerNorm)):
        mod.weight.fill_(1.0)
        if isinstance(mod, LayerNorm):
            mod.bias.zero_()


def build_dit(cfg: DiTConfig, device="cuda", dtype=torch.bfloat16,
              generator: Optional[torch.Generator] = None,
              trainable: bool = False) -> HYVideoDiT:
    """A DiT with storage allocated on `device` (no default init pass);
    random weights from `generator` when given, else uninitialized (to be
    filled by load_state_dict). Its parameters take gradients only with
    trainable=True (training.py); the model has no dropout or batch
    statistics, so it stays in eval mode either way."""
    with torch.device("meta"):
        model = HYVideoDiT(cfg, dtype=dtype)
    model = model.to_empty(device=device).eval().requires_grad_(trainable)
    if generator is not None:
        model.init_weights(generator)
    return model
