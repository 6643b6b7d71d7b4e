"""Plain reference of HunyuanVideo's MM-DiT denoise step (HYVideo-T/2), in
float32 with the products on TF32 (10-bit mantissa inputs, fp32 sums) and
the joint attention's operands in fp16 (10-bit mantissa, fp32 softmax and
sums), both finer than the bf16 the configuration states.

Follows the published model (hyvideo/modules/models.py, token_refiner.py,
posemb_layers.py, embed_layers.py, mlp_layers.py; the flow-match Euler
scheduler of hyvideo/diffusion/schedulers) with the configuration's
attention and weight tier worked out here again from the same seeded
weights:

* dense joint attention over [image | valid text] keys;
* sliding-tile attention (arXiv:2502.04507) for the image queries of every
  block past the first `dense_*_blocks`: the queries of a tile of the patch
  grid (tiles from the grid's origin, the last ones ragged) see the image
  keys of the tiles within the window around it, clipped at the grid's
  edges, and every valid text key; text queries keep full attention;
* tiers (`tiers()`): the block linears (modulation included) as W8A8
  (per-output-channel weight codes, per-row activation codes, round half
  to even, symmetric; W4A4 for the int8 configuration's control), and the
  STA image scores from per-(batch, tile, head) codes of q and k, as
  SageAttention-style int8 Q.K^T (arXiv:2410.02367); "fp8", the bf16
  configuration's control, rounds every block linear's operands (weights
  per tensor, inputs per row) and the attention's q, k, v (per tensor) to
  float8_e4m3.

Imports nothing of the program; its weights are drawn anew from the seed
(benchmark/weights.py) one block at a time.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import weights


# --------------------------------------------------------------------------
# schedule, embeddings, norms
# --------------------------------------------------------------------------

def sigmas(steps: int, shift: float) -> np.ndarray:
    """Flow-match sigmas [steps + 1] (float32): linspace(1, 0) under the SD3
    shift s*x / (1 + (s - 1)*x)."""
    x = np.linspace(1.0, 0.0, steps + 1, dtype=np.float64)
    return (shift * x / (1 + (shift - 1) * x)).astype(np.float32)


def timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """[cos | sin] of t times 10000^(-i/half), in float32 as the published
    embed_layers.py computes it."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    a = t.float()[:, None] * freqs[None]
    return torch.cat([a.cos(), a.sin()], -1)


def rope_tables(dims: Sequence[int], sizes: Sequence[int], theta: float,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [prod(sizes), sum(dims)]: per axis the 1-D frequencies
    theta^(-2i/dim) at the token's coordinate, each angle duplicated for
    its interleaved pair; float32 as the published posemb_layers.py."""
    grids = torch.meshgrid(*[torch.arange(s, dtype=torch.float32)
                             for s in sizes], indexing="ij")
    parts = []
    for dim, g in zip(dims, grids):
        f = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32)
                            / dim)
        parts.append(torch.outer(g.reshape(-1), f).repeat_interleave(2, -1))
    ang = torch.cat(parts, -1)
    return ang.cos().to(device), ang.sin().to(device)


def rope(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """x [B, S, H, D]: pairs (x0, x1) rotate to (x0 c - x1 s, x1 c + x0 s)."""
    x2 = x.unflatten(-1, (-1, 2))
    rot = torch.stack([-x2[..., 1], x2[..., 0]], -1).flatten(-2)
    return x * cos[None, :, None] + rot * sin[None, :, None]


def rms(x, w, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def ln(x, w=None, b=None, eps=1e-6):
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


# --------------------------------------------------------------------------
# linears and their weight tier
# --------------------------------------------------------------------------

def quant_rows(x: torch.Tensor, qmax: int):
    """Symmetric codes of each row of x (fp32 codes) and the row scales."""
    s = x.abs().amax(-1, keepdim=True).clamp_min(1e-8) / qmax
    return torch.round(x / s).clamp(-qmax, qmax), s


def quant_weight(w: torch.Tensor, qmax: int):
    """Per-output-channel codes of w [out, in] and scales [out]."""
    s = w.abs().amax(-1, keepdim=True).clamp_min(1e-12) / qmax
    return torch.round(w / s).clamp(-qmax, qmax), s[:, 0]


E4M3_MAX = 448.0


def fp8(x: torch.Tensor, dims=None) -> torch.Tensor:
    """x rounded to float8_e4m3 under one scale (per tensor, or over
    `dims`), back in float32."""
    a = x.abs().amax() if dims is None else x.abs().amax(dims, keepdim=True)
    s = a.clamp_min(1e-12) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Linears:
    """The block linears of one group, float32, as codes, or (tier "fp8")
    with float8_e4m3 operands."""

    def __init__(self, sd: dict, tier):
        self.sd = {k: v.float() for k, v in sd.items()}
        self.fp8 = tier == "fp8"
        self.qmax = None if tier in (None, "fp8") else 2 ** (tier - 1) - 1
        self.codes = {}

    def __call__(self, name: str, x: torch.Tensor, rows=None, cols=None,
                 bias: bool = True) -> torch.Tensor:
        """x @ W[rows, cols]^T + b[rows]: under a tier the weight's codes
        are taken over whole rows before any slice, and x's rows are
        quantized per call."""
        w = self.sd[f"{name}.weight"]
        b = self.sd.get(f"{name}.bias") if bias else None
        rows = slice(None) if rows is None else rows
        cols = slice(None) if cols is None else cols
        if b is not None:
            b = b[rows]
        if self.fp8:
            if name not in self.codes:
                self.codes[name] = fp8(w)
            y = fp8(x, -1) @ self.codes[name][rows, cols].t()
        elif self.qmax is None:
            y = x @ w[rows, cols].t()
        else:
            if name not in self.codes:
                self.codes[name] = quant_weight(w, self.qmax)
            wq, ws = self.codes[name]
            xq, xs = quant_rows(x, self.qmax)
            y = (xq @ wq[rows, cols].t()) * xs * ws[rows]
        return y + b if b is not None else y


def plain_linear(sd, name, x):
    return x @ sd[f"{name}.weight"].float().t() + sd[f"{name}.bias"].float()


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def dense_attention(q, k, v, n_img: int, valid: Sequence[int],
                    op_dtype) -> torch.Tensor:
    """q [B, Sq, H, D] over the keys [image | the first valid[b] text
    keys] of k, v [B, n_img + Lt, H, D]; operands rounded to `op_dtype`,
    softmax and sums in fp32 (SDPA). -> [B, Sq, H*D] fp32."""
    out = []
    for b in range(q.shape[0]):
        n = n_img + int(valid[b])
        qb, kb, vb = (t[b:b + 1, :m].transpose(1, 2).to(op_dtype)
                      for t, m in ((q, q.shape[1]), (k, n), (v, n)))
        o = F.scaled_dot_product_attention(qb, kb, vb)
        out.append(o.transpose(1, 2).float())
    o = torch.cat(out)
    return o.reshape(o.shape[0], o.shape[1], -1)


def tile_layout(grid, tile, window, device):
    """(tokens [n_tiles, block] row-major index of each tile slot, -1 past
    the grid; nbr [n_tiles, wt*wh*ww] the tiles within the window, -1
    outside the grid)."""
    (t, h, w), (tt, th, tw), (wt, wh, ww) = grid, tile, window
    gt, gh, gw = (-(-t // tt), -(-h // th), -(-w // tw))
    ct = torch.arange(gt * tt).view(gt, tt, 1, 1, 1, 1)
    ch = torch.arange(gh * th).view(1, 1, gh, th, 1, 1)
    cw = torch.arange(gw * tw).view(1, 1, 1, 1, gw, tw)
    idx = (ct * h + ch) * w + cw
    ok = (ct < t) & (ch < h) & (cw < w)
    idx = torch.where(ok, idx, -1).permute(0, 2, 4, 1, 3, 5)
    tokens = idx.reshape(gt * gh * gw, tt * th * tw)
    a, b, c = torch.meshgrid(torch.arange(gt), torch.arange(gh),
                             torch.arange(gw), indexing="ij")
    nb = []
    for da in range(-(wt // 2), wt // 2 + 1):
        for db in range(-(wh // 2), wh // 2 + 1):
            for dc in range(-(ww // 2), ww // 2 + 1):
                aa, bb, cc = a + da, b + db, c + dc
                inside = ((aa >= 0) & (aa < gt) & (bb >= 0) & (bb < gh)
                          & (cc >= 0) & (cc < gw))
                nb.append(torch.where(inside, (aa * gh + bb) * gw + cc, -1))
    nbr = torch.stack([x.reshape(-1) for x in nb], -1)
    return tokens.to(device), nbr.to(device)


def tile_codes(xt: torch.Tensor, qmax: int):
    """xt [B, n_tiles, block, H, D] -> (codes, scales [B, n_tiles, H]) per
    (batch, tile, head)."""
    s = xt.abs().amax(dim=(2, 4)).clamp_min(1e-6) / qmax
    return torch.round(xt / s[:, :, None, :, None]), s


def _sdpa(q, k, v, mask, scale):
    """SDPA of [B, H, S, D] operands with a boolean key mask [B, 1, 1, S];
    on the card the memory-efficient kernel (fp32 softmax and sums)."""
    if q.device.type != "cuda":
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              scale=scale)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              scale=scale)


def sta_image_attention(iq, ik, iv, tk, tv, valid, grid, tile, window,
                        qk_bits: Optional[int] = None, op_dtype=None,
                        chunk_tiles: int = 16) -> torch.Tensor:
    """The image queries [B, S_img, H, D] under sliding tiles, plus every
    valid text key, -> [B, S_img, H*D] fp32. Each query tile attends to
    the gathered keys of exactly its window's tiles and the valid text
    keys; operands in `op_dtype` (fp16 on the card), softmax and sums in
    fp32. Under `qk_bits` the image scores are those of the per-(tile,
    head) codes, (q codes * sq).(k codes * sk), and the text scores those
    of the raw q: the operands are [dequantized q | q] against [dequantized
    k | 0] for image keys and [0 | k] for text keys."""
    b, s_img, hh, d = iq.shape
    dev = iq.device
    op_dtype = op_dtype or (torch.float16 if dev.type == "cuda"
                            else torch.float32)
    tokens, nbr = tile_layout(grid, tile, window, dev)
    n_tiles, block = tokens.shape
    ok = tokens >= 0
    safe = tokens.clamp_min(0)
    out = torch.empty(b, s_img, hh * d, device=dev)
    for bi in range(b):
        def tiles(x):
            return (x[bi, safe] * ok[:, :, None, None]).to(op_dtype)

        qt, kt, vt = tiles(iq), tiles(ik), tiles(iv)   # [T, K, H, D]
        n_txt = int(valid[bi])
        txt_k, txt_v = (x[bi, :n_txt].to(op_dtype) for x in (tk, tv))
        if qk_bits is not None:
            qmax = 2 ** (qk_bits - 1) - 1
            (qc, sq), (kc, sk) = (tile_codes(
                (x[bi, safe] * ok[:, :, None, None])[None], qmax)
                for x in (iq, ik))
            qd = (qc[0] * sq[0, :, None, :, None]).to(op_dtype)
            kd = (kc[0] * sk[0, :, None, :, None]).to(op_dtype)
            qt = torch.cat([qd, qt], -1)
            kt = torch.cat([kd, torch.zeros_like(kd)], -1)
            txt_k = torch.cat([torch.zeros_like(txt_k), txt_k], -1)
        out_t = torch.empty(n_tiles, block, hh * d, device=dev)
        for c0 in range(0, n_tiles, chunk_tiles):
            cs = slice(c0, min(c0 + chunk_tiles, n_tiles))
            nb = nbr[cs]
            cn, nn_ = nb.shape
            key_ok = (ok[nb.clamp_min(0)] & (nb >= 0)[..., None]).reshape(
                cn, nn_ * block)
            mask = torch.cat([key_ok, key_ok.new_ones(cn, n_txt)], 1)
            k = torch.cat([kt[nb.clamp_min(0)].reshape(cn, nn_ * block, hh,
                                                        -1),
                           txt_k.expand(cn, *txt_k.shape)], 1)
            v = torch.cat([vt[nb.clamp_min(0)].reshape(cn, nn_ * block, hh,
                                                        d),
                           txt_v.expand(cn, *txt_v.shape)], 1)
            o = _sdpa(qt[cs].transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), mask[:, None, None, :], d ** -0.5)
            out_t[cs] = o.transpose(1, 2).reshape(cn, block, hh * d).float()
        out[bi, tokens[ok]] = out_t[ok]
    return out


# --------------------------------------------------------------------------
# the DiT
# --------------------------------------------------------------------------

def patchify(x: torch.Tensor, patch) -> torch.Tensor:
    """[B, C, T, H, W] -> [B, T'H'W', C*pt*ph*pw] (the conv kernel's
    feature order)."""
    b, c, t, h, w = x.shape
    pt, ph, pw = patch
    x = x.reshape(b, c, t // pt, pt, h // ph, ph, w // pw, pw)
    return x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(
        b, (t // pt) * (h // ph) * (w // pw), c * pt * ph * pw)


def unpatchify(x: torch.Tensor, grid, c: int, patch) -> torch.Tensor:
    """[B, L, pt*ph*pw*C] -> [B, C, T, H, W]."""
    (tt, th, tw), (pt, ph, pw) = grid, patch
    b = x.shape[0]
    x = x.reshape(b, tt, th, tw, c, pt, ph, pw)
    x = torch.einsum("nthwcopq->nctohpwq", x)
    return x.reshape(b, c, tt * pt, th * ph, tw * pw)


def _refiner(sd, x, t, mask, heads):
    """The single token refiner (token_refiner.py), x [B, L, 4096]."""
    h = sd["txt_in.input_embedder.weight"].shape[0]
    r = "txt_in"

    def mlp_t(name, v):
        return plain_linear(sd, f"{name}.mlp.2",
                            F.silu(plain_linear(sd, f"{name}.mlp.0", v)))

    mf = mask.float()[..., None]
    ctx = (x * mf).sum(1) / mf.sum(1).clamp_min(1.0)
    c = mlp_t(f"{r}.t_embedder", timestep_embedding(t)) + plain_linear(
        sd, f"{r}.c_embedder.linear_2",
        F.silu(plain_linear(sd, f"{r}.c_embedder.linear_1", ctx)))
    m = mask.bool()
    keep = (m[:, None, :] & m[:, :, None])
    keep[:, :, 0] = True
    bias = torch.where(keep, 0.0, float("-inf"))[:, None]
    x = plain_linear(sd, f"{r}.input_embedder", x)
    b, l, _ = x.shape
    i = 0
    while f"{r}.individual_token_refiner.blocks.{i}.norm1.weight" in sd:
        p = f"{r}.individual_token_refiner.blocks.{i}"
        g_msa, g_mlp = plain_linear(sd, f"{p}.adaLN_modulation.1",
                                    F.silu(c)).chunk(2, -1)
        a = ln(x, sd[f"{p}.norm1.weight"].float(), sd[f"{p}.norm1.bias"].float())
        q, k, v = (u.reshape(b, l, heads, -1).transpose(1, 2)
                   for u in plain_linear(sd, f"{p}.self_attn_qkv", a)
                   .chunk(3, -1))
        s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]) + bias
        o = (s.softmax(-1) @ v).transpose(1, 2).reshape(b, l, h)
        x = x + plain_linear(sd, f"{p}.self_attn_proj", o) * g_msa[:, None]
        a = ln(x, sd[f"{p}.norm2.weight"].float(), sd[f"{p}.norm2.bias"].float())
        f = plain_linear(sd, f"{p}.mlp.fc2",
                         F.silu(plain_linear(sd, f"{p}.mlp.fc1", a)))
        x = x + f * g_mlp[:, None]
        i += 1
    return x


@torch.no_grad()
def dit_forward(cfg: dict, seed: int, x_tokens, t, txt, mask, pooled, grid,
                tiers=(None, None), attn_dtype=torch.float16) -> torch.Tensor:
    """Output patch tokens [B, L_img, 64] of the DiT on raw patch tokens
    x_tokens [B, L_img, 64] (fp32), timesteps t [B], text states [B, Lt,
    4096], text mask [B, Lt], CLIP pooled [B, 768]; `cfg` the benchmark's
    configuration file. tiers = (the block linears' tier, the attention's
    tier), each None, a width in bits or "fp8" (`tiers(cfg)`)."""
    lin_tier, attn_tier = tiers
    dit, sta = cfg["dit"], cfg["sta"]
    dev = x_tokens.device
    hh = dit["heads_num"]
    h = dit["hidden_size"]
    d = h // hh
    valid = [int(v) for v in mask.sum(-1).tolist()]
    cos, sin = rope_tables(dit["rope_dim_list"], grid, dit["rope_theta"], dev)
    act = {"gelu_tanh": gelu_tanh}[dit["mlp_act_type"]]
    dtype = {"bf16": torch.bfloat16, "fp16": torch.float16,
             "fp32": torch.float32}[cfg["precision"]]
    groups = weights.state_dicts("dit", dit, seed, dev, dtype)

    _, sd = next(groups)
    vec = (plain_linear(sd, "time_in.mlp.2", F.silu(plain_linear(
        sd, "time_in.mlp.0", timestep_embedding(t))))
        + plain_linear(sd, "vector_in.out_layer", F.silu(plain_linear(
            sd, "vector_in.in_layer", pooled))))
    w_in = sd["img_in.proj.weight"].float()
    img = x_tokens @ w_in.reshape(w_in.shape[0], -1).t() \
        + sd["img_in.proj.bias"].float()
    txt = _refiner(sd, txt, t, mask, hh)
    del sd
    b, n_img, _ = img.shape
    lt = txt.shape[1]
    svec = F.silu(vec)

    def heads(x):
        return x.reshape(x.shape[0], x.shape[1], hh, d)

    def attend(iq, ik, iv, tq, tk, tv, use_sta):
        """(image out, text out), each [B, S, H*D]."""
        if attn_tier == "fp8":
            iq, ik, iv, tq, tk, tv = map(fp8, (iq, ik, iv, tq, tk, tv))
        if not use_sta:
            out = dense_attention(torch.cat([iq, tq], 1),
                                  torch.cat([ik, tk], 1),
                                  torch.cat([iv, tv], 1), n_img, valid,
                                  attn_dtype)
            return out[:, :n_img], out[:, n_img:]
        img_o = sta_image_attention(iq, ik, iv, tk, tv, valid, grid,
                                    sta["tile"], sta["window"],
                                    qk_bits=attn_tier if attn_tier != "fp8"
                                    else None)
        txt_o = dense_attention(tq, torch.cat([ik, tk], 1),
                                torch.cat([iv, tv], 1), n_img, valid,
                                attn_dtype)
        return img_o, txt_o

    n_double = dit["mm_double_blocks_depth"]
    for i in range(n_double):
        _, sd = next(groups)
        lin = Linears(sd, lin_tier)
        use_sta = sta is not None and i >= sta["dense_double_blocks"]
        im = lin("img_mod.linear", svec).chunk(6, -1)
        tm = lin("txt_mod.linear", svec).chunk(6, -1)
        qkv = []
        for s, x, m in (("img", img, im), ("txt", txt, tm)):
            q, k, v = map(heads, lin(f"{s}_attn_qkv", modulate(
                ln(x), m[0], m[1])).chunk(3, -1))
            q = rms(q, lin.sd[f"{s}_attn_q_norm.weight"])
            k = rms(k, lin.sd[f"{s}_attn_k_norm.weight"])
            if s == "img":
                q, k = rope(q, cos, sin), rope(k, cos, sin)
            qkv.append((q, k, v))
        (iq, ik, iv), (tq, tk, tv) = qkv
        img_a, txt_a = attend(iq, ik, iv, tq, tk, tv, use_sta)
        del qkv, iq, ik, iv, tq, tk, tv
        out = []
        for s, x, a, m in (("img", img, img_a, im), ("txt", txt, txt_a, tm)):
            x = x + lin(f"{s}_attn_proj", a) * m[2][:, None]
            f = act(lin(f"{s}_mlp.fc1", modulate(ln(x), m[3], m[4])))
            out.append(x + lin(f"{s}_mlp.fc2", f) * m[5][:, None])
        img, txt = out
        del lin, sd, img_a, txt_a, out
    x = torch.cat([img, txt], 1)
    del img, txt
    h3 = 3 * h
    for i in range(dit["mm_single_blocks_depth"]):
        _, sd = next(groups)
        lin = Linears(sd, lin_tier)
        use_sta = sta is not None and i >= sta["dense_single_blocks"]
        shift, scale, gate = lin("modulation.linear", svec).chunk(3, -1)
        xm = modulate(ln(x), shift, scale)
        q, k, v = map(heads, lin("linear1", xm, rows=slice(0, h3))
                      .chunk(3, -1))
        hid = act(lin("linear1", xm, rows=slice(h3, None)))
        del xm
        q = rms(q, lin.sd["q_norm.weight"])
        k = rms(k, lin.sd["k_norm.weight"])
        iq, ik = rope(q[:, :n_img], cos, sin), rope(k[:, :n_img], cos, sin)
        img_a, txt_a = attend(iq, ik, v[:, :n_img], q[:, n_img:],
                              k[:, n_img:], v[:, n_img:], use_sta)
        del q, k, v, iq, ik
        a = torch.cat([img_a, txt_a], 1)
        del img_a, txt_a
        out = lin("linear2", a, cols=slice(0, h)) + lin(
            "linear2", hid, cols=slice(h, None), bias=False)
        x = x + out * gate[:, None]
        del lin, sd, a, hid, out
    _, sd = next(groups)
    shift, scale = plain_linear(sd, "adaLN_modulation.1", svec).chunk(2, -1)
    return plain_linear(sd, "linear", modulate(ln(x[:, :n_img]), shift,
                                               scale))


@torch.no_grad()
def tiers(cfg: dict, control: bool = False):
    """(the block linears' tier, the attention's tier) of the configuration
    (None where it keeps the model type, 8 for its int8 tiers), or of its
    control, the nearest precision below: int4 for the int8 tiers, fp8 for
    bf16 (the configuration file's `control.reference_tier`)."""
    for flag in ("use_fp8", "use_int4_modulation"):
        if cfg.get(flag):
            raise NotImplementedError(f"the plain reference has no {flag} "
                                      f"tier; a configuration with it "
                                      f"needs one")
    own = (8 if cfg["use_int8"] else None,
           8 if cfg["attn_mode"] == "sta_int8" else None)
    if not control:
        return own
    low = cfg["control"]["reference_tier"]
    return tuple(low if (t is not None or low == "fp8") else None
                 for t in own)


def cfg_velocities(cfg: dict, seed: int, latents: List[torch.Tensor],
                   timesteps: List[float], text, guidance_scale: float,
                   tiers=(None, None),
                   attn_dtype=torch.float16) -> List[torch.Tensor]:
    """The guided velocity v_u + g (v_c - v_u) at each (latent [1, C, T, H,
    W], timestep) pair, all pairs in one batch through the DiT (CFG order
    [negative, positive] as the published pipeline). `text` = (states
    [2, Lt, 4096], mask [2, Lt], pooled [2, 768]) of [negative,
    positive]."""
    dit = cfg["dit"]
    patch = dit["patch_size"]
    pe, mask, pooled = text
    n = len(latents)
    x = torch.cat([torch.cat([l, l]) for l in latents]).float()
    t = torch.tensor([tt for tt in timesteps for _ in range(2)],
                     dtype=torch.float32, device=x.device)
    _, _, lt_, lh, lw = x.shape
    grid = (lt_ // patch[0], lh // patch[1], lw // patch[2])
    out = dit_forward(cfg, seed, patchify(x, patch), t, pe.repeat(n, 1, 1),
                      mask.repeat(n, 1), pooled.repeat(n, 1), grid, tiers,
                      attn_dtype)
    v = unpatchify(out, grid, dit["out_channels"], patch)
    return [v[2 * i:2 * i + 1] + guidance_scale
            * (v[2 * i + 1:2 * i + 2] - v[2 * i:2 * i + 1])
            for i in range(n)]
