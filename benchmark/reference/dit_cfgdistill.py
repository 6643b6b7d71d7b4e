"""Plain reference of the guidance-distilled HunyuanVideo DiT's denoise
step (HYVideo-T/2-cfgdistill, the released checkpoint's mode), in float32
with the joint attention's operands in fp16 on the card (10-bit mantissa,
fp32 softmax and sums; float32 on the CPU).

Follows the published forward (hyvideo/modules/models.py,
HYVideoDiffusionTransformer.forward with guidance_embed): the conditioning
vector is

    vec = time_in(t) + vector_in(pooled) + guidance_in(g),

with g the embedded guidance scale times 1000 and guidance_in a
TimestepEmbedder; one batch-1 forward a step, no negative prompt and no
CFG combination, so the velocity is the DiT's output v = DiT(x, t, g). The
blocks are those of reference/dit.py's dense path (QK-RMSNorm, 3-axis
RoPE on the image tokens, dense joint attention over [image | valid text]
keys), whose helpers this file imports; the forward is this file's own.

Departures from the published model: the attention's operands are fp16 on
the card (SDPA, fp32 softmax and sums), and the weights are drawn anew
from the seed one block at a time (benchmark/weights.py), so that no whole
model is ever resident. The "fp8" control rounds every block linear's
operands (weights per tensor, inputs per row) and the attention's q, k, v
(per tensor) to float8_e4m3, as reference/dit.py's control does.

Imports nothing of the program.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from .. import weights
from .dit import (Linears, dense_attention, fp8, gelu_tanh, ln, modulate,
                  patchify, plain_linear, rms, rope, rope_tables, _refiner,
                  timestep_embedding, unpatchify)


def _timestep_mlp(sd, name, t):
    return plain_linear(sd, f"{name}.mlp.2", F.silu(plain_linear(
        sd, f"{name}.mlp.0", timestep_embedding(t))))


@torch.no_grad()
def dit_forward(cfg: dict, seed: int, x_tokens, t, guidance, txt, mask,
                pooled, grid, control: bool = False,
                attn_dtype=torch.float16) -> torch.Tensor:
    """Output patch tokens [B, L_img, 64] of the DiT on raw patch tokens
    x_tokens [B, L_img, 64] (fp32), timesteps t [B], guidance [B] (the
    embedded scale times 1000; None leaves the guidance term out, which
    only the tests do), text states [B, Lt, 4096], text mask [B, Lt], CLIP
    pooled [B, 768]; `cfg` the benchmark's configuration file; `control`
    the fp8 operands of the configuration's control."""
    tier = "fp8" if control else None
    dit = cfg["dit"]
    dev = x_tokens.device
    hh = dit["heads_num"]
    h = dit["hidden_size"]
    d = h // hh
    valid = [int(v) for v in mask.sum(-1).tolist()]
    cos, sin = rope_tables(dit["rope_dim_list"], grid, dit["rope_theta"], dev)
    dtype = {"bf16": torch.bfloat16, "fp16": torch.float16,
             "fp32": torch.float32}[cfg["precision"]]
    groups = weights.state_dicts("dit", dit, seed, dev, dtype)

    _, sd = next(groups)
    vec = _timestep_mlp(sd, "time_in", t) + plain_linear(
        sd, "vector_in.out_layer", F.silu(plain_linear(
            sd, "vector_in.in_layer", pooled)))
    if guidance is not None:
        vec = vec + _timestep_mlp(sd, "guidance_in", guidance)
    w_in = sd["img_in.proj.weight"].float()
    img = x_tokens @ w_in.reshape(w_in.shape[0], -1).t() \
        + sd["img_in.proj.bias"].float()
    txt = _refiner(sd, txt, t, mask, hh)
    del sd
    n_img = img.shape[1]
    svec = F.silu(vec)

    def heads(x):
        return x.reshape(x.shape[0], x.shape[1], hh, d)

    def attend(q, k, v):
        """Joint attention of [image | text] q, k, v -> [B, S, H*D]."""
        if control:
            q, k, v = map(fp8, (q, k, v))
        return dense_attention(q, k, v, n_img, valid, attn_dtype)

    for _ in range(dit["mm_double_blocks_depth"]):
        _, sd = next(groups)
        lin = Linears(sd, tier)
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
        a = attend(*(torch.cat(p, 1) for p in zip(*qkv)))
        del qkv
        out = []
        for s, x, a_s, m in (("img", img, a[:, :n_img], im),
                             ("txt", txt, a[:, n_img:], tm)):
            x = x + lin(f"{s}_attn_proj", a_s) * m[2][:, None]
            f = gelu_tanh(lin(f"{s}_mlp.fc1", modulate(ln(x), m[3], m[4])))
            out.append(x + lin(f"{s}_mlp.fc2", f) * m[5][:, None])
        img, txt = out
        del lin, sd, a, out
    x = torch.cat([img, txt], 1)
    del img, txt
    h3 = 3 * h
    for _ in range(dit["mm_single_blocks_depth"]):
        _, sd = next(groups)
        lin = Linears(sd, tier)
        shift, scale, gate = lin("modulation.linear", svec).chunk(3, -1)
        xm = modulate(ln(x), shift, scale)
        q, k, v = map(heads, lin("linear1", xm, rows=slice(0, h3))
                      .chunk(3, -1))
        hid = gelu_tanh(lin("linear1", xm, rows=slice(h3, None)))
        del xm
        q = rms(q, lin.sd["q_norm.weight"])
        k = rms(k, lin.sd["k_norm.weight"])
        q = torch.cat([rope(q[:, :n_img], cos, sin), q[:, n_img:]], 1)
        k = torch.cat([rope(k[:, :n_img], cos, sin), k[:, n_img:]], 1)
        a = attend(q, k, v)
        del q, k, v
        out = lin("linear2", a, cols=slice(0, h)) + lin(
            "linear2", hid, cols=slice(h, None), bias=False)
        x = x + out * gate[:, None]
        del lin, sd, a, hid, out
    _, sd = next(groups)
    shift, scale = plain_linear(sd, "adaLN_modulation.1", svec).chunk(2, -1)
    return plain_linear(sd, "linear", modulate(ln(x[:, :n_img]), shift,
                                               scale))


def velocities(cfg: dict, seed: int, latents: List[torch.Tensor],
               timesteps: List[float], text,
               embedded_guidance: Optional[float], control: bool = False,
               attn_dtype=torch.float16) -> List[torch.Tensor]:
    """The velocity v = DiT(x, t, g) at each (latent [1, C, T, H, W],
    timestep) pair, one batch row a pair through one forward, g =
    embedded_guidance * 1000 (None: no guidance term). `text` = (states
    [1, Lt, 4096], mask [1, Lt], pooled [1, 768]) of the prompt."""
    dit = cfg["dit"]
    patch = dit["patch_size"]
    pe, mask, pooled = text
    n = len(latents)
    x = torch.cat(latents).float()
    t = torch.tensor(timesteps, dtype=torch.float32, device=x.device)
    g = None if embedded_guidance is None else torch.full(
        (n,), embedded_guidance * 1000.0, device=x.device)
    _, _, lt_, lh, lw = x.shape
    grid = (lt_ // patch[0], lh // patch[1], lw // patch[2])
    out = dit_forward(cfg, seed, patchify(x, patch), t, g, pe.repeat(n, 1, 1),
                      mask.repeat(n, 1), pooled.repeat(n, 1), grid, control,
                      attn_dtype)
    v = unpatchify(out, grid, dit["out_channels"], patch)
    return list(v.split(1))
