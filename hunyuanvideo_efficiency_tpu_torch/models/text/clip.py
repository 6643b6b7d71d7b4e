"""CLIP-L/14 text tower, pooled output (JAX counterpart: models/text/clip.py;
reference: hyvideo/text_encoder/__init__.py:32-34, 171-178).

Module names are the HF CLIPTextTransformer state-dict keys (without the
`text_model.` prefix): 12 pre-LN layers, quick-GELU MLP, causal attention,
final LayerNorm; the pooled output is the final hidden state at the first
EOS token.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn

from ...ops.norms import layer_norm


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


CLIP_L = CLIPTextConfig()


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, **fk):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, **fk))
        self.bias = nn.Parameter(torch.zeros(dim, **fk))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **fk):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.q_proj = nn.Linear(h, h, **fk)
        self.k_proj = nn.Linear(h, h, **fk)
        self.v_proj = nn.Linear(h, h, **fk)
        self.out_proj = nn.Linear(h, h, **fk)

    def forward(self, x, bias):
        b, l, _ = x.shape
        hh, d = self.cfg.num_attention_heads, self.cfg.head_dim
        q = self.q_proj(x).reshape(b, l, hh, d).transpose(1, 2)
        k = self.k_proj(x).reshape(b, l, hh, d).transpose(1, 2)
        v = self.v_proj(x).reshape(b, l, hh, d).transpose(1, 2)
        scores = torch.matmul(q.float() * d ** -0.5,
                              k.float().transpose(-1, -2))
        probs = torch.softmax(scores + bias, dim=-1)
        out = torch.matmul(probs.to(v.dtype), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, l, hh * d))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **fk):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **fk)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **fk)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **fk):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.layer_norm1 = LayerNorm(cfg.hidden_size, eps, **fk)
        self.self_attn = CLIPAttention(cfg, **fk)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, eps, **fk)
        self.mlp = CLIPMLP(cfg, **fk)

    def forward(self, x, bias):
        x = x + self.self_attn(self.layer_norm1(x), bias)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **fk):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            **fk)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size, **fk)


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **fk):
        super().__init__()
        self.layers = nn.ModuleList(CLIPLayer(cfg, **fk)
                                    for _ in range(cfg.num_hidden_layers))


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.embeddings = CLIPEmbeddings(cfg, **fk)
        self.encoder = CLIPEncoder(cfg, **fk)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                          **fk)

    @torch.no_grad()
    def encode(self, input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(last_hidden_state [B, L, H], pooler_output [B, H])."""
        b, l = input_ids.shape
        dev = input_ids.device
        emb = self.embeddings
        x = emb.token_embedding(input_ids) + emb.position_embedding.weight[:l]
        keep = torch.ones((l, l), dtype=torch.bool, device=dev).tril()
        keep = keep[None, None]
        if attention_mask is not None:
            keep = keep & attention_mask.bool()[:, None, None, :]
        bias = torch.where(keep, 0.0, -1e30).float()
        for layer in self.encoder.layers:
            x = layer(x, bias)
        x = self.final_layer_norm(x)
        eos = (input_ids == self.cfg.eos_token_id).int().argmax(dim=-1)
        return x, x[torch.arange(b, device=dev), eos]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CLIPTextModel":
        """Random weights as the JAX init_clip_params draws them."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.normal_(0.0, mod.in_features ** -0.5,
                                   generator=generator)
                mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self.embeddings.token_embedding.weight.normal_(0.0, 0.02,
                                                       generator=generator)
        self.embeddings.position_embedding.weight.normal_(
            0.0, 0.01, generator=generator)
        return self
