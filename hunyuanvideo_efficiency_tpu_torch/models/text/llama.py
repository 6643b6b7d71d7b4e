"""Llama-3 decoder as the LLM text encoder (JAX counterpart:
models/text/llama.py; reference: hyvideo/text_encoder/__init__.py:32-41,
300-316).

Module names are the HF LlamaModel state-dict keys. The DiT reads
hidden_states[-(skip+1)]: the output of layer num_layers - skip without the
final RMSNorm, so only those layers run. GQA, non-interleaved RoPE
(rotate-half over split halves), SwiGLU MLP; attention is plain matmul +
fp32 softmax.

Tensor parallelism (JAX models/text/llama.py:shard_llama_params, :308-345;
there a placement that XLA partitions, here an explicit split): q, k, v,
gate and up are column-parallel (each rank holds whole heads and its slice
of the intermediate width), o_proj and down_proj row-parallel (each rank's
slice of the input features, its partial product summed over the ranks),
the embedding and the norms replicated. `shard_llama` splits a model in
place for this rank of a parallel.comm.GroupComm; `llama_rank_shards`
returns every rank's shard (sharing the replicated tensors) for ranks run
in turn (parallel.comm.LocalComm). Under int8 a row-parallel layer keeps
the one-rank numerics: the activation amax is all-reduced (MAX) before the
quantization, so every rank quantizes its K slice with the whole row's
scale, W8A8 (B9) returns the s32 sums, which are all-reduced as integers,
and the dequant follows, as the one-rank epilogue computes it: the int8
tower equals the one-rank int8 tower bit for bit, and a bf16 or fp32 tower
differs from the one-rank one only by the order of the row-parallel sums.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.int8_matmul import row_scales, w8a8_linear
from ...ops.norms import rms_norm
from ...ops.quantization import Int8Linear, linear


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
        # this rank's heads (all of them unless tensor-parallel)
        self.n_heads = cfg.num_attention_heads
        self.n_kv_heads = cfg.num_key_value_heads

    def heads(self, x, bias, cos, sin):
        """The attention of this rank's heads, [B, L, n_heads * head_dim]:
        the input of o_proj. One GQA group (a key-value head and its query
        heads) a batched product, each operand contiguous: a
        tensor-parallel rank holds whole groups, so it runs each group's
        products with the same shapes as one rank does (cuBLAS may take
        another algorithm, and other bits, for another batch count)."""
        b, l, _ = x.shape
        hq, hkv, d = self.n_heads, self.n_kv_heads, self.cfg.head_dim
        q = self.q_proj(x).reshape(b, l, hq, d).float()
        k = self.k_proj(x).reshape(b, l, hkv, d).float()
        v = self.v_proj(x).reshape(b, l, hkv, d)
        c, s = cos[None, :, None, :], sin[None, :, None, :]
        q = q * c + _rotate_half(q) * s
        k = k * c + _rotate_half(k) * s
        rep = hq // hkv
        q = (q * d ** -0.5).transpose(1, 2)
        k, v = k.transpose(1, 2), v.transpose(1, 2).to(x.dtype)
        out = []
        for j in range(hkv):
            qg = q[:, j * rep:(j + 1) * rep].contiguous()
            kg, vg = (t[:, j:j + 1].expand(b, rep, l, d).contiguous()
                      for t in (k, v))
            scores = torch.matmul(qg, kg.transpose(-1, -2)) + bias
            probs = torch.softmax(scores.float(), dim=-1)
            out.append(torch.matmul(probs.to(vg.dtype), vg))
        return torch.cat(out, 1).transpose(1, 2).reshape(b, l, hq * d)

    def forward(self, x, bias, cos, sin):
        return self.o_proj(self.heads(x, bias, cos, sin))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, **fk):
        super().__init__()
        h, m = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(h, m, bias=False, **fk)
        self.up_proj = nn.Linear(h, m, bias=False, **fk)
        self.down_proj = nn.Linear(m, h, bias=False, **fk)

    def hidden(self, x):
        """silu(gate(x)) * up(x): the input of down_proj."""
        return F.silu(self.gate_proj(x)) * self.up_proj(x)

    def forward(self, x):
        return self.down_proj(self.hidden(x))


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
        # the ranks of a tensor-parallel tower (parallel/comm.py), or None
        self.tp = None

    @torch.no_grad()
    def encode(self, input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor],
               hidden_state_skip_layer: int = 2,
               apply_final_norm: bool = False) -> torch.Tensor:
        """Hidden states [B, L, hidden] after layer
        num_hidden_layers - skip (the reference's hidden_states[-(skip+1)]);
        a tensor-parallel model runs its rank's shard with the others."""
        return encode_shards([self], self.tp, input_ids, attention_mask,
                             hidden_state_skip_layer, apply_final_norm)

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


@torch.no_grad()
def encode_shards(models: Sequence[LlamaModel], comm,
                  input_ids: torch.Tensor,
                  attention_mask: Optional[torch.Tensor],
                  hidden_state_skip_layer: int = 2,
                  apply_final_norm: bool = False) -> torch.Tensor:
    """LlamaModel.encode over the shards of comm.ranks (one model, comm
    None: the one-rank tower): each layer's replicated norms once, each
    rank's column-parallel work and row-parallel partial in turn, the
    partials reduced by `comm`."""
    m0 = models[0]
    cfg = m0.cfg
    l = input_ids.shape[1]
    dev = input_ids.device
    x = m0.embed_tokens(input_ids)
    keep = torch.ones((l, l), dtype=torch.bool, device=dev).tril()
    keep = keep[None, None]
    if attention_mask is not None:
        keep = keep & attention_mask.bool()[:, None, None, :]
    bias = torch.where(keep, 0.0, -1e30).float()
    cos, sin = _rope_tables(cfg, l, dev)
    n_run = cfg.num_hidden_layers - max(hidden_state_skip_layer, 0)
    for i in range(n_run):
        layers = [m.layers[i] for m in models]
        if comm is None:
            x = layers[0](x, bias, cos, sin)
            continue
        h = layers[0].input_layernorm(x)
        x = x + row_parallel(
            [lay.self_attn.o_proj for lay in layers],
            [lay.self_attn.heads(h, bias, cos, sin) for lay in layers], comm)
        h = layers[0].post_attention_layernorm(x)
        x = x + row_parallel([lay.mlp.down_proj for lay in layers],
                             [lay.mlp.hidden(h) for lay in layers], comm)
    if hidden_state_skip_layer == 0 or apply_final_norm:
        x = m0.norm(x)
    return x


def row_parallel(mods: Sequence[nn.Module], xs: Sequence[torch.Tensor],
                 comm) -> torch.Tensor:
    """sum over the ranks of xs[r] @ mods[r].weight^T, each rank's K slice.
    int8 (B9's two arms): the amax all-reduced (MAX) and quantized with that
    scale, the s32 sums all-reduced (SUM, exact), then the epilogue's
    dequant in fp32, (s32 * sx) * scale_out, stored in x's type."""
    if isinstance(mods[0], Int8Linear):
        sx = row_scales(comm.max([x.abs().amax(dim=-1).float()
                                  for x in xs]))
        acc = comm.sum([w8a8_linear(x, m.weight, m.scale_out, row_scale=sx,
                                    s32=True) for m, x in zip(mods, xs)])
        return (acc.float() * sx[..., None]
                * mods[0].scale_out.float()).to(xs[0].dtype)
    return comm.sum([linear(m, x) for m, x in zip(mods, xs)])


def check_tp_divisible(cfg: LlamaConfig, world: int) -> None:
    """The explicit split needs whole heads and equal slices on every rank;
    a readable error where Llama's widths do not divide the world."""
    for name in ("num_attention_heads", "num_key_value_heads",
                 "intermediate_size"):
        if getattr(cfg, name) % world:
            raise ValueError(
                f"tensor-parallel Llama over {world} ranks: {name} "
                f"{getattr(cfg, name)} is not divisible by {world} (the "
                f"tower splits whole heads and the intermediate width "
                f"evenly; Llama-3-8B divides 2, 4 and 8)")


def _sliced(mod: nn.Module, rows: Optional[slice] = None,
            cols: Optional[slice] = None) -> nn.Module:
    """A bias-free linear (nn.Linear or Int8Linear) holding a copy of
    mod's weight[rows, cols]; an int8 column (K) slice keeps the whole
    scale_out, a row (N) slice its rows."""
    rows, cols = rows or slice(None), cols or slice(None)
    w = mod.weight[rows, cols].clone()
    if isinstance(mod, Int8Linear):
        return Int8Linear(w, mod.scale_out[rows].clone())
    if type(mod) is not nn.Linear or mod.bias is not None:
        raise TypeError(f"tensor-parallel Llama: cannot split {mod}")
    new = nn.Linear(w.shape[1], w.shape[0], bias=False, device="meta")
    new.weight = nn.Parameter(w, requires_grad=False)
    return new


def _shard_layer(src: LlamaLayer, dst: LlamaLayer, rank: int,
                 world: int) -> None:
    """dst's linears become rank's slices of src's; norms shared."""
    cfg = src.self_attn.cfg
    d = cfg.head_dim

    def part(n):
        return slice(rank * n // world, (rank + 1) * n // world)

    a, m = src.self_attn, src.mlp
    q, kv = part(cfg.num_attention_heads * d), part(
        cfg.num_key_value_heads * d)
    mid = part(cfg.intermediate_size)
    dst.input_layernorm = src.input_layernorm
    dst.post_attention_layernorm = src.post_attention_layernorm
    da, dm = dst.self_attn, dst.mlp
    da.q_proj = _sliced(a.q_proj, rows=q)
    da.k_proj = _sliced(a.k_proj, rows=kv)
    da.v_proj = _sliced(a.v_proj, rows=kv)
    da.o_proj = _sliced(a.o_proj, cols=q)
    da.n_heads = cfg.num_attention_heads // world
    da.n_kv_heads = cfg.num_key_value_heads // world
    dm.gate_proj = _sliced(m.gate_proj, rows=mid)
    dm.up_proj = _sliced(m.up_proj, rows=mid)
    dm.down_proj = _sliced(m.down_proj, cols=mid)


def shard_llama_layer(layer: LlamaLayer, comm) -> LlamaLayer:
    """`layer` in place: this rank's slices of its linears (the full ones
    freed)."""
    _shard_layer(layer, layer, comm.rank, comm.world)
    return layer


def shard_llama(model: LlamaModel, comm) -> LlamaModel:
    """`model` in place: tensor-parallel over comm (parallel.comm.
    GroupComm), each layer cut to this rank's slices, the full weights
    freed one layer at a time (quantize first: an int8 row-parallel slice
    keeps the whole row's scale_out)."""
    check_tp_divisible(model.cfg, comm.world)
    for layer in model.layers:
        shard_llama_layer(layer, comm)
    model.tp = comm
    return model


def llama_rank_shards(model: LlamaModel, comm) -> List[LlamaModel]:
    """Every rank's shard of `model` for ranks run in turn
    (parallel.comm.LocalComm): new models holding their rank's slices and
    sharing the embedding and norms with `model`, each with tp = comm;
    `model` stays whole (the one-rank reference)."""
    check_tp_divisible(model.cfg, comm.world)
    shards = []
    for r in comm.ranks:
        with torch.device("meta"):
            shard = LlamaModel(model.cfg)
        shard.embed_tokens, shard.norm = model.embed_tokens, model.norm
        for src, dst in zip(model.layers, shard.layers):
            _shard_layer(src, dst, r, comm.world)
        shard.eval().requires_grad_(False)
        shard.tp = comm
        shards.append(shard)
    return shards
