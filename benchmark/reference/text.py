"""Plain reference of the text conditioning: the stand-in tokenizer, the
prompt template, the Llama-3 tower (hidden states two layers before the
last, cropped) and the CLIP-L tower (pooled at the first EOS), in float32.

Follows the published HunyuanVideo text encoder
(hyvideo/text_encoder/__init__.py: template, crop_start, hidden_state_skip_layer
= 2) and the HF Llama / CLIP forward passes. The tokenizer is the
repository's whitespace-and-hash stand-in (no tokenizer files are in the
repository), restated here; `hash` of a str depends on PYTHONHASHSEED, which
the benchmark fixes. Weights come from benchmark/weights.py, one layer at a
time. Imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import weights

# hyvideo/constants.py: the video template and its crop, and the default
# negative prompt (frozen copies)
PROMPT_TEMPLATE_VIDEO = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the video by "
    "detailing the following aspects: "
    "1. The main content and theme of the video."
    "2. The color, shape, size, texture, quantity, text, and spatial "
    "relationships of the objects."
    "3. Actions, events, behaviors temporal relationships, physical movement "
    "changes of the objects."
    "4. background environment, light, style and atmosphere."
    "5. camera angles, movements, and transitions used in the video:"
    "<|eot_id|><|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>")
NEGATIVE_PROMPT = (
    "Aerial view, aerial view, overexposed, low quality, deformation, a poor "
    "composition, bad hands, bad teeth, bad eyes, bad limbs, distortion")


def hash_tokens(text: str, vocab_size: int, max_length: int, eos: int,
                bos: int = 1):
    """(ids, mask) [max_length] int64: bos, one id a whitespace word
    (2 + hash(word) % (vocab - 3)), eos, right padding with 0."""
    toks = [bos] + [2 + (hash(w) % (vocab_size - 3)) for w in text.split()]
    toks = toks[:max_length - 1] + [eos]
    ids = np.zeros(max_length, np.int64)
    mask = np.zeros(max_length, np.int64)
    ids[:len(toks)] = toks
    mask[:len(toks)] = 1
    return ids, mask


def llm_tokens(prompt: str, text_cfg: dict):
    llm = text_cfg["llm"]
    return hash_tokens(PROMPT_TEMPLATE_VIDEO.format(prompt), llm["vocab_size"],
                       text_cfg["text_len"] + text_cfg["crop_start"],
                       llm["vocab_size"] - 1)


def clip_tokens(prompt: str, text_cfg: dict):
    clip = text_cfg["clip"]
    return hash_tokens(prompt, clip["vocab_size"], text_cfg["text_len_2"],
                       clip["eos_token_id"])


def text_valid(prompt: str, text_cfg: dict) -> int:
    """Valid Llama positions the DiT sees after the crop."""
    _, mask = llm_tokens(prompt, text_cfg)
    return int(mask[text_cfg["crop_start"]:].sum())


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _causal_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, 1, L, L] additive: key j visible to query i iff j <= i and
    mask[j]."""
    l = mask.shape[-1]
    keep = torch.ones((l, l), dtype=torch.bool, device=mask.device).tril()
    keep = keep[None, None] & mask.bool()[:, None, None, :]
    return torch.where(keep, 0.0, float("-inf"))


def _f32(sd):
    return {k: v.float() for k, v in sd.items()}


@torch.no_grad()
def llama_hidden(ids: torch.Tensor, mask: torch.Tensor, text_cfg: dict,
                 seed: int, dtype) -> torch.Tensor:
    """Llama-3 hidden states [B, L, H] after layer n - skip, no final norm;
    the layers drawn one at a time (in `dtype`, the served type) and
    computed in fp32."""
    cfg = text_cfg["llm"]
    dev = ids.device
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    h = cfg["hidden_size"]
    d = h // hq
    n_run = cfg["num_hidden_layers"] - text_cfg["hidden_state_skip_layer"]
    eps = cfg["rms_norm_eps"]
    (_, emb), = weights.state_dicts("llm", cfg, seed, dev, dtype,
                                    only={"embed"})
    x = emb["embed_tokens.weight"][ids].float()
    del emb
    b, l = ids.shape
    inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(0, d, 2, device=dev,
                                                    dtype=torch.float32) / d))
    ang = torch.outer(torch.arange(l, device=dev, dtype=torch.float32), inv)
    ang = torch.cat([ang, ang], -1)          # float32, as HF Llama
    cos, sin = ang.cos(), ang.sin()

    def rope(t):                      # rotate-half over split halves
        t1, t2 = t.chunk(2, -1)
        return t * cos[:, None] + torch.cat([-t2, t1], -1) * sin[:, None]

    bias = _causal_bias(mask)
    tags = {f"layers.{i}" for i in range(n_run)}
    for _, w in weights.state_dicts("llm", cfg, seed, dev, dtype, only=tags):
        w = _f32(w)
        a = _rms(x, w["input_layernorm.weight"], eps)
        q = rope((a @ w["self_attn.q_proj.weight"].t()).view(b, l, hq, d))
        k = rope((a @ w["self_attn.k_proj.weight"].t()).view(b, l, hkv, d))
        v = (a @ w["self_attn.v_proj.weight"].t()).view(b, l, hkv, d)
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d) + bias
        o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
        x = x + o.reshape(b, l, h) @ w["self_attn.o_proj.weight"].t()
        a = _rms(x, w["post_attention_layernorm.weight"], eps)
        g = a @ w["mlp.gate_proj.weight"].t()
        u = a @ w["mlp.up_proj.weight"].t()
        x = x + (torch.nn.functional.silu(g) * u) @ w["mlp.down_proj.weight"].t()
    return x


def _ln(x, w, b, eps):
    return torch.nn.functional.layer_norm(x, x.shape[-1:], w, b, eps)


@torch.no_grad()
def clip_pooled(ids: torch.Tensor, mask: torch.Tensor, text_cfg: dict,
                seed: int, dtype) -> torch.Tensor:
    """CLIP-L's final-LayerNorm state at the first EOS token, [B, H]."""
    cfg = text_cfg["clip"]
    dev = ids.device
    hh, h = cfg["num_attention_heads"], cfg["hidden_size"]
    d = h // hh
    eps = cfg["layer_norm_eps"]
    b, l = ids.shape
    x = None
    bias = _causal_bias(mask)
    for tag, w in weights.state_dicts("clip", cfg, seed, dev, dtype):
        w = _f32(w)
        if tag == "embed":
            x = (w["embeddings.token_embedding.weight"][ids]
                 + w["embeddings.position_embedding.weight"][:l])
        elif tag == "final_layer_norm":
            x = _ln(x, w["final_layer_norm.weight"],
                    w["final_layer_norm.bias"], eps)
        else:
            def lin(name, t):
                return t @ w[f"{name}.weight"].t() + w[f"{name}.bias"]

            a = _ln(x, w["layer_norm1.weight"], w["layer_norm1.bias"], eps)
            q, k, v = (lin(f"self_attn.{p}_proj", a).view(b, l, hh, d)
                       for p in ("q", "k", "v"))
            s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d) + bias
            o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
            x = x + lin("self_attn.out_proj", o.reshape(b, l, h))
            a = _ln(x, w["layer_norm2.weight"], w["layer_norm2.bias"], eps)
            f = lin("mlp.fc1", a)
            x = x + lin("mlp.fc2", f * torch.sigmoid(1.702 * f))
    eos = (ids == cfg["eos_token_id"]).int().argmax(-1)
    return x[torch.arange(b, device=dev), eos]


@torch.no_grad()
def encode(prompts, text_cfg: dict, seed: int, device):
    """(text states [B, text_len, 4096], mask [B, text_len], pooled
    [B, 768]) of `prompts`, all fp32, in the order given."""
    dtype = {"fp16": torch.float16, "bf16": torch.bfloat16,
             "fp32": torch.float32}[text_cfg["precision"]]
    lt = [llm_tokens(p, text_cfg) for p in prompts]
    ct = [clip_tokens(p, text_cfg) for p in prompts]

    def stack(toks, i):
        return torch.as_tensor(np.stack([t[i] for t in toks]), device=device)

    ids, mask = stack(lt, 0), stack(lt, 1)
    crop = text_cfg["crop_start"]
    hidden = llama_hidden(ids, mask, text_cfg, seed, dtype)[:, crop:]
    pooled = clip_pooled(stack(ct, 0), stack(ct, 1), text_cfg, seed, dtype)
    return hidden, mask[:, crop:], pooled
