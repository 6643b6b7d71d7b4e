"""Llama-3 decoder as the LLM text encoder (JAX counterpart:
models/text/llama.py; reference: hyvideo/text_encoder/__init__.py:32-41,
300-316).

Module names are the HF LlamaModel state-dict keys. The DiT reads
hidden_states[-(skip+1)]: the output of layer num_layers - skip without the
final RMSNorm, so only those layers run. GQA, non-interleaved RoPE
(rotate-half over split halves), SwiGLU MLP; attention is plain matmul +
fp32 softmax.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.norms import rms_norm


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128320
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


LLAMA3_8B = LlamaConfig()


def _rope_tables(cfg: LlamaConfig, seq_len: int, device):
    """HF-style cos/sin [L, head_dim], angles duplicated by concatenation."""
    d = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float32) / d))
    freqs = np.outer(np.arange(seq_len, dtype=np.float32), inv)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (torch.from_numpy(np.cos(emb)).to(device),
            torch.from_numpy(np.sin(emb)).to(device))


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, **fk):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, **fk))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, **fk):
        super().__init__()
        self.cfg = cfg
        h, d = cfg.hidden_size, cfg.head_dim
        self.q_proj = nn.Linear(h, cfg.num_attention_heads * d, bias=False,
                                **fk)
        self.k_proj = nn.Linear(h, cfg.num_key_value_heads * d, bias=False,
                                **fk)
        self.v_proj = nn.Linear(h, cfg.num_key_value_heads * d, bias=False,
                                **fk)
        self.o_proj = nn.Linear(cfg.num_attention_heads * d, h, bias=False,
                                **fk)

    def forward(self, x, bias, cos, sin):
        cfg = self.cfg
        b, l, _ = x.shape
        hq, hkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        q = self.q_proj(x).reshape(b, l, hq, d).float()
        k = self.k_proj(x).reshape(b, l, hkv, d).float()
        v = self.v_proj(x).reshape(b, l, hkv, d)
        c, s = cos[None, :, None, :], sin[None, :, None, :]
        q = q * c + _rotate_half(q) * s
        k = k * c + _rotate_half(k) * s
        rep = hq // hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
        scores = torch.matmul((q * d ** -0.5).transpose(1, 2),
                              k.permute(0, 2, 3, 1)) + bias
        probs = torch.softmax(scores.float(), dim=-1)
        out = torch.matmul(probs.to(v.dtype), v.transpose(1, 2).to(x.dtype))
        return self.o_proj(out.transpose(1, 2).reshape(b, l, hq * d))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, **fk):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(h, m, bias=False, **fk)
        self.up_proj = nn.Linear(h, m, bias=False, **fk)
        self.down_proj = nn.Linear(m, h, bias=False, **fk)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, **fk):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **fk)
        self.self_attn = LlamaAttention(cfg, **fk)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, **fk)
        self.mlp = LlamaMLP(cfg, **fk)

    def forward(self, x, bias, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), bias, cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **fk)
        self.layers = nn.ModuleList(LlamaLayer(cfg, **fk)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **fk)

    @torch.no_grad()
    def encode(self, input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor],
               hidden_state_skip_layer: int = 2,
               apply_final_norm: bool = False) -> torch.Tensor:
        """Hidden states [B, L, hidden] after layer
        num_hidden_layers - skip (the reference's hidden_states[-(skip+1)])."""
        cfg = self.cfg
        l = input_ids.shape[1]
        dev = input_ids.device
        x = self.embed_tokens(input_ids)
        keep = torch.ones((l, l), dtype=torch.bool, device=dev).tril()
        keep = keep[None, None]
        if attention_mask is not None:
            keep = keep & attention_mask.bool()[:, None, None, :]
        bias = torch.where(keep, 0.0, -1e30).float()
        cos, sin = _rope_tables(cfg, l, dev)
        n_run = cfg.num_hidden_layers - max(hidden_state_skip_layer, 0)
        for layer in self.layers[:n_run]:
            x = layer(x, bias, cos, sin)
        if hidden_state_skip_layer == 0 or apply_final_norm:
            x = self.norm(x)
        return x

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LlamaModel":
        """Random weights as the JAX init_llama_params draws them: linears
        N(0, 1/fan_in), embedding N(0, 0.02^2), unit norm scales."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, mod.in_features ** -0.5,
                                   generator=generator)
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 0.02, generator=generator)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
        return self
