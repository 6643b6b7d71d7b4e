"""Seeded weights that the benchmark makes and hands to both sides.

The benchmark, not the program, draws every weight: the program loads them
through its public modules (`load_state_dict`), and the plain reference
draws the very same tensors again from the same seed, one group (a block, a
layer) at a time, so that it never needs a whole model resident and never
reads a tensor the program made. The names are the published checkpoints'
state-dict keys (HunyuanVideo's DiT and VAE, HF Llama and CLIP), which the
program's modules also use.

A group is drawn by one `torch.randn` call into one flat buffer, in the type
the weights are served in, on the card, from a generator seeded by the run's
`--seed` and the group's tag; each leaf is then a view of that buffer,
scaled in place. Leaf kinds: ("w", std) N(0, std^2); ("n", std) 1 + N(0,
std^2) (norm scales); ("a", std) |N(0, std^2)| (LPIPS heads).

Imports nothing of the program.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterator, List, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], Tuple[str, float]]

BIAS_STD = 0.01
NORM_STD = 0.05
EMBED_STD = 0.02


def group_seed(seed: int, tag: str) -> int:
    """A 63-bit generator seed for group `tag` of run seed `seed`."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def make_group(leaves: List[Leaf], seed: int, tag: str, device,
               dtype) -> Dict[str, torch.Tensor]:
    """The group's tensors, views of one flat buffer drawn in `dtype`."""
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    g = torch.Generator(device=device).manual_seed(group_seed(seed, tag))
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    out, off = {}, 0
    for name, shape, (kind, std) in leaves:
        n = math.prod(shape)
        v = flat[off:off + n].view(shape)
        off += n
        v.mul_(std)
        if kind == "n":
            v.add_(1.0)
        elif kind == "a":
            v.abs_()
        out[name] = v
    return out


def _linear(name: str, n_out: int, n_in: int, std: float,
            bias: bool = True) -> List[Leaf]:
    leaves = [(f"{name}.weight", (n_out, n_in), ("w", std))]
    if bias:
        leaves.append((f"{name}.bias", (n_out,), ("w", BIAS_STD)))
    return leaves


def _norm(name: str, dim: int, bias: bool) -> List[Leaf]:
    leaves = [(f"{name}.weight", (dim,), ("n", NORM_STD))]
    if bias:
        leaves.append((f"{name}.bias", (dim,), ("w", BIAS_STD)))
    return leaves


# --------------------------------------------------------------------------
# HunyuanVideo DiT (hyvideo/modules/models.py key names)
# --------------------------------------------------------------------------

def _dense_std(fan_in: int) -> float:
    """The variance of uniform(+-1/sqrt(fan_in)), the DiT's own init."""
    return (3.0 * fan_in) ** -0.5


MOD_GAIN = 2.0


def _mod_std(fan_in: int) -> float:
    """N(0, MOD_GAIN^2 / fan_in) for the adaLN, modulation and final layers
    (see _timestep_mlp)."""
    return MOD_GAIN / math.sqrt(fan_in)


def _timestep_mlp(name: str, h: int, freq: int = 256) -> List[Leaf]:
    """N(0, 1/fan_in): the conditioning vector then has unit scale, so the
    adaLN gates and scales are O(0.1-1) as in a trained model and every
    block moves the output (with the checkpoints' N(0, 0.02^2) the gates
    stay ~0.05 and the blocks barely register)."""
    return (_linear(f"{name}.mlp.0", h, freq, freq ** -0.5)
            + _linear(f"{name}.mlp.2", h, h, h ** -0.5))


def dit_groups(dit: dict) -> Iterator[Tuple[str, List[Leaf]]]:
    """(tag, leaves) of every DiT group in model order: the embedders and
    the token refiner, each double block, each single block, the final
    layer."""
    h = dit["hidden_size"]
    d = h // dit["heads_num"]
    m = int(h * dit["mlp_width_ratio"])
    td, td2 = dit["text_states_dim"], dit["text_states_dim_2"]
    pt, ph, pw = dit["patch_size"]
    cin = dit["in_channels"]
    fan_patch = cin * pt * ph * pw
    emb = [("img_in.proj.weight", (h, cin, pt, ph, pw),
            ("w", _dense_std(fan_patch))),
           ("img_in.proj.bias", (h,), ("w", BIAS_STD))]
    emb += _timestep_mlp("time_in", h)
    emb += _linear("vector_in.in_layer", h, td2, td2 ** -0.5)
    emb += _linear("vector_in.out_layer", h, h, h ** -0.5)
    if dit["guidance_embed"]:
        emb += _timestep_mlp("guidance_in", h)
    r = "txt_in"
    emb += _linear(f"{r}.input_embedder", h, td, _dense_std(td))
    emb += _timestep_mlp(f"{r}.t_embedder", h)
    emb += _linear(f"{r}.c_embedder.linear_1", h, td, _dense_std(td))
    emb += _linear(f"{r}.c_embedder.linear_2", h, h, _dense_std(h))
    for i in range(dit["refiner_depth"]):
        b = f"{r}.individual_token_refiner.blocks.{i}"
        emb += _norm(f"{b}.norm1", h, True)
        emb += _linear(f"{b}.self_attn_qkv", 3 * h, h, _dense_std(h))
        emb += _linear(f"{b}.self_attn_proj", h, h, _dense_std(h))
        emb += _norm(f"{b}.norm2", h, True)
        emb += _linear(f"{b}.mlp.fc1", 4 * h, h, _dense_std(h))
        emb += _linear(f"{b}.mlp.fc2", h, 4 * h, _dense_std(4 * h))
        emb += _linear(f"{b}.adaLN_modulation.1", 2 * h, h, _mod_std(h))
    yield "embed", emb
    bias = dit["qkv_bias"]
    for i in range(dit["mm_double_blocks_depth"]):
        leaves = []
        for s in ("img", "txt"):
            leaves += _linear(f"{s}_mod.linear", 6 * h, h, _mod_std(h))
            leaves += _linear(f"{s}_attn_qkv", 3 * h, h, _dense_std(h), bias)
            leaves += _norm(f"{s}_attn_q_norm", d, False)
            leaves += _norm(f"{s}_attn_k_norm", d, False)
            leaves += _linear(f"{s}_attn_proj", h, h, _dense_std(h), bias)
            leaves += _linear(f"{s}_mlp.fc1", m, h, _dense_std(h))
            leaves += _linear(f"{s}_mlp.fc2", h, m, _dense_std(m))
        yield f"double_blocks.{i}", leaves
    for i in range(dit["mm_single_blocks_depth"]):
        leaves = (_linear("linear1", 3 * h + m, h, _dense_std(h))
                  + _linear("linear2", h, h + m, _dense_std(h + m))
                  + _norm("q_norm", d, False) + _norm("k_norm", d, False)
                  + _linear("modulation.linear", 3 * h, h, _mod_std(h)))
        yield f"single_blocks.{i}", leaves
    out = pt * ph * pw * dit["out_channels"]
    yield "final_layer", (_linear("linear", out, h, _mod_std(h))
                          + _linear("adaLN_modulation.1", 2 * h, h,
                                    _mod_std(h)))


# --------------------------------------------------------------------------
# Llama-3-8B and CLIP-L text towers (HF key names)
# --------------------------------------------------------------------------

def llama_groups(cfg: dict) -> Iterator[Tuple[str, List[Leaf]]]:
    """("embed", ...), ("layers.<i>", ...) for every layer, ("norm", ...)."""
    h, im = cfg["hidden_size"], cfg["intermediate_size"]
    d = h // cfg["num_attention_heads"]
    kv = cfg["num_key_value_heads"] * d
    yield "embed", [("embed_tokens.weight", (cfg["vocab_size"], h),
                     ("w", EMBED_STD))]
    s_h, s_im = h ** -0.5, im ** -0.5
    for i in range(cfg["num_hidden_layers"]):
        yield f"layers.{i}", (
            _norm("input_layernorm", h, False)
            + _linear("self_attn.q_proj", h, h, s_h, False)
            + _linear("self_attn.k_proj", kv, h, s_h, False)
            + _linear("self_attn.v_proj", kv, h, s_h, False)
            + _linear("self_attn.o_proj", h, h, s_h, False)
            + _norm("post_attention_layernorm", h, False)
            + _linear("mlp.gate_proj", im, h, s_h, False)
            + _linear("mlp.up_proj", im, h, s_h, False)
            + _linear("mlp.down_proj", h, im, s_im, False))
    yield "norm", _norm("norm", h, False)


def clip_groups(cfg: dict) -> Iterator[Tuple[str, List[Leaf]]]:
    h, im = cfg["hidden_size"], cfg["intermediate_size"]
    yield "embed", [
        ("embeddings.token_embedding.weight", (cfg["vocab_size"], h),
         ("w", EMBED_STD)),
        ("embeddings.position_embedding.weight",
         (cfg["max_position_embeddings"], h), ("w", EMBED_STD / 2))]
    s_h, s_im = h ** -0.5, im ** -0.5
    for i in range(cfg["num_hidden_layers"]):
        b = f"encoder.layers.{i}"
        yield b, (_norm("layer_norm1", h, True)
                  + _linear("self_attn.q_proj", h, h, s_h)
                  + _linear("self_attn.k_proj", h, h, s_h)
                  + _linear("self_attn.v_proj", h, h, s_h)
                  + _linear("self_attn.out_proj", h, h, s_h)
                  + _norm("layer_norm2", h, True)
                  + _linear("mlp.fc1", im, h, s_h)
                  + _linear("mlp.fc2", h, im, s_im))
    yield "final_layer_norm", _norm("final_layer_norm", h, True)


# --------------------------------------------------------------------------
# Causal-3D VAE (hyvideo/vae key names) and LPIPS
# --------------------------------------------------------------------------

def _conv(name: str, cout: int, cin: int, k: int) -> List[Leaf]:
    fan = cin * k ** 3
    return [(f"{name}.weight", (cout, cin, k, k, k), ("w", fan ** -0.5)),
            (f"{name}.bias", (cout,), ("w", BIAS_STD))]


def _resnet(name: str, cin: int, cout: int) -> List[Leaf]:
    leaves = (_norm(f"{name}.norm1", cin, True)
              + _conv(f"{name}.conv1.conv", cout, cin, 3)
              + _norm(f"{name}.norm2", cout, True)
              + _conv(f"{name}.conv2.conv", cout, cout, 3))
    if cin != cout:
        leaves += _conv(f"{name}.conv_shortcut.conv", cout, cin, 1)
    return leaves


def _mid(name: str, c: int) -> List[Leaf]:
    a = f"{name}.attentions.0"
    return (_resnet(f"{name}.resnets.0", c, c)
            + _norm(f"{a}.group_norm", c, True)
            + _linear(f"{a}.to_q", c, c, c ** -0.5)
            + _linear(f"{a}.to_k", c, c, c ** -0.5)
            + _linear(f"{a}.to_v", c, c, c ** -0.5)
            + _linear(f"{a}.to_out.0", c, c, c ** -0.5)
            + _resnet(f"{name}.resnets.1", c, c))


def vae_down_stride(cfg: dict, i: int):
    """Block i's downsampler stride (t, h, w), or None: the 884 schedule
    (hyvideo/vae/vae.py:59-96); the decoder's up block i upsamples by the
    same factor."""
    n = len(cfg["block_out_channels"])
    n_s = int(math.log2(cfg["spatial_compression_ratio"]))
    n_t = int(math.log2(cfg["time_compression_ratio"]))
    final = i == n - 1
    spatial = i < n_s
    temporal = i >= (n - 1 - n_t) and not final
    if not (spatial or temporal):
        return None
    return (2 if temporal else 1, 2 if spatial else 1, 2 if spatial else 1)


def vae_groups(cfg: dict) -> Iterator[Tuple[str, List[Leaf]]]:
    bo, lc = cfg["block_out_channels"], cfg["latent_channels"]
    n, lpb = len(bo), cfg["layers_per_block"]
    enc = _conv("encoder.conv_in.conv", bo[0], cfg["in_channels"], 3)
    for i in range(n):
        cin = bo[0] if i == 0 else bo[i - 1]
        for j in range(lpb):
            enc += _resnet(f"encoder.down_blocks.{i}.resnets.{j}",
                           cin if j == 0 else bo[i], bo[i])
        if vae_down_stride(cfg, i) is not None:
            enc += _conv(f"encoder.down_blocks.{i}.downsamplers.0.conv.conv",
                         bo[i], bo[i], 3)
    enc += _mid("encoder.mid_block", bo[-1])
    enc += _norm("encoder.conv_norm_out", bo[-1], True)
    enc += _conv("encoder.conv_out.conv", 2 * lc, bo[-1], 3)
    enc += _conv("quant_conv", 2 * lc, 2 * lc, 1)
    yield "encoder", enc
    rev = list(reversed(bo))
    dec = _conv("post_quant_conv", lc, lc, 1)
    dec += _conv("decoder.conv_in.conv", bo[-1], lc, 3)
    dec += _mid("decoder.mid_block", bo[-1])
    for i in range(n):
        cin = rev[0] if i == 0 else rev[i - 1]
        for j in range(lpb + 1):
            dec += _resnet(f"decoder.up_blocks.{i}.resnets.{j}",
                           cin if j == 0 else rev[i], rev[i])
        if vae_down_stride(cfg, i) is not None:
            dec += _conv(f"decoder.up_blocks.{i}.upsamplers.0.conv.conv",
                         rev[i], rev[i], 3)
    dec += _norm("decoder.conv_norm_out", bo[0], True)
    dec += _conv("decoder.conv_out.conv", cfg["out_channels"], bo[0], 3)
    yield "decoder", dec


# LPIPS's AlexNet taps: (out channels, kernel, stride, padding)
LPIPS_ALEX = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
              (256, 3, 1, 1), (256, 3, 1, 1))


def lpips_groups() -> Iterator[Tuple[str, List[Leaf]]]:
    """Random LPIPS as the repository draws it for runs without its
    weights: convs N(0, 0.1^2), heads |N(0, 0.01^2)|."""
    leaves, cin = [], 3
    for i, (cout, k, _, _) in enumerate(LPIPS_ALEX):
        leaves += [(f"features.{i}.weight", (cout, cin, k, k), ("w", 0.1)),
                   (f"features.{i}.bias", (cout,), ("w", BIAS_STD))]
        cin = cout
    for i, (cout, *_) in enumerate(LPIPS_ALEX):
        leaves.append((f"lins.{i}.weight", (1, cout, 1, 1), ("a", 0.01)))
    yield "lpips", leaves


GROUPS = {"dit": dit_groups, "llm": llama_groups, "clip": clip_groups,
          "vae": vae_groups}


def state_dicts(model: str, cfg: dict, seed: int, device, dtype,
                only=None) -> Iterator[Tuple[str, Dict[str, torch.Tensor]]]:
    """(tag, state dict) of each group of `model` ("dit", "llm", "clip",
    "vae", "lpips"), drawn in turn; `only` limits the tags drawn."""
    groups = lpips_groups() if model == "lpips" else GROUPS[model](cfg)
    for tag, leaves in groups:
        if only is None or tag in only:
            yield tag, make_group(leaves, seed, f"{model}.{tag}", device,
                                  dtype)
