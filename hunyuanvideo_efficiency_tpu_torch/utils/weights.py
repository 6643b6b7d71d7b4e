"""JAX parameter trees -> the port's state dicts.

The inverse of the JAX package's checkpoint converters
(utils/checkpoint.py:convert_dit_state_dict and convert_vae_state_dict,
models/text/llama.py:convert_llama_state_dict,
models/text/clip.py:convert_clip_state_dict): a tree passed as nested
dicts/lists of numpy arrays (stacked blocks along axis 0) becomes a
{key: fp32 tensor} dict that the port's modules `load_state_dict`, so both
packages can compute with identical weights. Layouts:

  kernel [in, out]                  -> Linear weight [out, in]
  conv kernel [kt, kh, kw, cin, out] -> Conv3d weight [out, cin, kt, kh, kw]
  patch matmul [cin*pt*ph*pw, out]   -> PatchEmbed Conv3d [out, cin, pt, ph, pw]
  pointwise kernel [cin, out]        -> Conv3d weight [out, cin, 1, 1, 1]
  norm scale                         -> weight

Quantized linears (the JAX ops/quantization.py trees) carry over bit for
bit into the port's tier modules (ops/quantization.py), which the model
must hold before `load_state_dict`:

  {'kernel' s8 [in, out], 'scale_out' [.., 1, out]} -> Int8Linear weight
      int8 [out, in], scale_out [out]
  {'kernel' e4m3 [in, out], 'scale' [.., 1, 1]}     -> Fp8Linear weight
      float8_e4m3fn [out, in], scale (0-d)
  {'kernel_i4' u8 [in, out/2], 'scale_out'}         -> Int4Linear weight
      uint8 [out/2, in], scale_out [out]
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

Tree = Dict[str, Any]
StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _codes(a: np.ndarray) -> torch.Tensor:
    """[in, out] integer or fp8 codes -> [out, in], the same bits."""
    a = np.ascontiguousarray(np.asarray(a).T)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def _lin(sd: StateDict, name: str, p: Tree) -> None:
    if "kernel_i4" in p:
        sd[f"{name}.weight"] = _codes(p["kernel_i4"])
        sd[f"{name}.scale_out"] = _t(np.asarray(p["scale_out"]).reshape(-1))
    elif "scale_out" in p:
        sd[f"{name}.weight"] = _codes(p["kernel"])
        sd[f"{name}.scale_out"] = _t(np.asarray(p["scale_out"]).reshape(-1))
    elif "scale" in p:
        sd[f"{name}.weight"] = _codes(p["kernel"])
        sd[f"{name}.scale"] = _t(np.asarray(p["scale"]).reshape(()))
    else:
        sd[f"{name}.weight"] = _t(np.asarray(p["kernel"], np.float32).T)
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _norm(sd: StateDict, name: str, p: Tree) -> None:
    if "scale" in p:
        sd[f"{name}.weight"] = _t(p["scale"])
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _conv(sd: StateDict, name: str, p: Tree) -> None:
    sd[f"{name}.weight"] = _t(
        np.asarray(p["kernel"], np.float32).transpose(4, 3, 0, 1, 2))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _pointwise(sd: StateDict, name: str, p: Tree) -> None:
    w = np.asarray(p["kernel"], np.float32).T
    sd[f"{name}.weight"] = _t(w.reshape(*w.shape, 1, 1, 1))
    sd[f"{name}.bias"] = _t(p["bias"])


def _ts_embedder(sd: StateDict, name: str, p: Tree) -> None:
    _lin(sd, f"{name}.mlp.0", p["mlp_0"])
    _lin(sd, f"{name}.mlp.2", p["mlp_2"])


def _index(tree, i: int):
    """Entry i of a tree stacked on axis 0."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _depth(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def dit_state_dict_from_jax(params: Tree, cfg) -> StateDict:
    """models/dit.py tree -> HYVideoDiT state dict (reference key names)."""
    sd: StateDict = {}
    w = np.asarray(params["img_in"]["kernel"], np.float32).T
    sd["img_in.proj.weight"] = _t(w.reshape(w.shape[0], cfg.in_channels,
                                            *cfg.patch_size))
    sd["img_in.proj.bias"] = _t(params["img_in"]["bias"])
    _ts_embedder(sd, "time_in", params["time_in"])
    _lin(sd, "vector_in.in_layer", params["vector_in"]["in_layer"])
    _lin(sd, "vector_in.out_layer", params["vector_in"]["out_layer"])
    if cfg.guidance_embed:
        _ts_embedder(sd, "guidance_in", params["guidance_in"])
    tx = params["txt_in"]
    if cfg.text_projection == "single_refiner":
        _lin(sd, "txt_in.input_embedder", tx["input_embedder"])
        _ts_embedder(sd, "txt_in.t_embedder", tx["t_embedder"])
        _lin(sd, "txt_in.c_embedder.linear_1", tx["c_embedder"]["linear_1"])
        _lin(sd, "txt_in.c_embedder.linear_2", tx["c_embedder"]["linear_2"])
        for i, blk in enumerate(tx["blocks"]):
            b = f"txt_in.individual_token_refiner.blocks.{i}"
            _norm(sd, f"{b}.norm1", blk["norm1"])
            _lin(sd, f"{b}.self_attn_qkv", blk["self_attn_qkv"])
            _lin(sd, f"{b}.self_attn_proj", blk["self_attn_proj"])
            _norm(sd, f"{b}.norm2", blk["norm2"])
            _lin(sd, f"{b}.mlp.fc1", blk["mlp"]["fc1"])
            _lin(sd, f"{b}.mlp.fc2", blk["mlp"]["fc2"])
            _lin(sd, f"{b}.adaLN_modulation.1", blk["adaLN_modulation"])
    else:
        _lin(sd, "txt_in.linear_1", tx["linear_1"])
        _lin(sd, "txt_in.linear_2", tx["linear_2"])
    for i in range(_depth(params["double_blocks"])):
        p = _index(params["double_blocks"], i)
        b = f"double_blocks.{i}"
        for s in ("img", "txt"):
            _lin(sd, f"{b}.{s}_mod.linear", p[f"{s}_mod"])
            _lin(sd, f"{b}.{s}_attn_qkv", p[f"{s}_attn_qkv"])
            _norm(sd, f"{b}.{s}_attn_q_norm", p[f"{s}_attn_q_norm"])
            _norm(sd, f"{b}.{s}_attn_k_norm", p[f"{s}_attn_k_norm"])
            _lin(sd, f"{b}.{s}_attn_proj", p[f"{s}_attn_proj"])
            _lin(sd, f"{b}.{s}_mlp.fc1", p[f"{s}_mlp"]["fc1"])
            _lin(sd, f"{b}.{s}_mlp.fc2", p[f"{s}_mlp"]["fc2"])
    for i in range(_depth(params["single_blocks"])):
        p = _index(params["single_blocks"], i)
        b = f"single_blocks.{i}"
        _lin(sd, f"{b}.linear1", p["linear1"])
        _lin(sd, f"{b}.linear2", p["linear2"])
        _norm(sd, f"{b}.q_norm", p["q_norm"])
        _norm(sd, f"{b}.k_norm", p["k_norm"])
        _lin(sd, f"{b}.modulation.linear", p["modulation"])
    _lin(sd, "final_layer.linear", params["final_layer"]["linear"])
    _lin(sd, "final_layer.adaLN_modulation.1",
         params["final_layer"]["adaLN_modulation"])
    return sd


def _resnet(sd: StateDict, base: str, p: Tree) -> None:
    _norm(sd, f"{base}.norm1", p["norm1"])
    _conv(sd, f"{base}.conv1.conv", p["conv1"])
    _norm(sd, f"{base}.norm2", p["norm2"])
    _conv(sd, f"{base}.conv2.conv", p["conv2"])
    if "conv_shortcut" in p:
        _conv(sd, f"{base}.conv_shortcut.conv", p["conv_shortcut"])


def _mid(sd: StateDict, base: str, p: Tree) -> None:
    for j, rp in enumerate(p["resnets"]):
        _resnet(sd, f"{base}.resnets.{j}", rp)
    for j, ap in enumerate(p.get("attentions", [])):
        a = f"{base}.attentions.{j}"
        _norm(sd, f"{a}.group_norm", ap["group_norm"])
        for k in ("to_q", "to_k", "to_v"):
            _lin(sd, f"{a}.{k}", ap[k])
        _lin(sd, f"{a}.to_out.0", ap["to_out"])


def vae_state_dict_from_jax(params: Tree) -> StateDict:
    """models/vae.py tree -> AutoencoderKLCausal3D state dict."""
    sd: StateDict = {}
    enc, dec = params["encoder"], params["decoder"]
    _conv(sd, "encoder.conv_in.conv", enc["conv_in"])
    for i, blk in enumerate(enc["down_blocks"]):
        for j, rp in enumerate(blk["resnets"]):
            _resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", rp)
        if "downsampler" in blk:
            _conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv.conv",
                  blk["downsampler"])
    _mid(sd, "encoder.mid_block", enc["mid_block"])
    _norm(sd, "encoder.conv_norm_out", enc["conv_norm_out"])
    _conv(sd, "encoder.conv_out.conv", enc["conv_out"])
    _conv(sd, "decoder.conv_in.conv", dec["conv_in"])
    _mid(sd, "decoder.mid_block", dec["mid_block"])
    for i, blk in enumerate(dec["up_blocks"]):
        for j, rp in enumerate(blk["resnets"]):
            _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", rp)
        if "upsampler" in blk:
            _conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv.conv",
                  blk["upsampler"])
    _norm(sd, "decoder.conv_norm_out", dec["conv_norm_out"])
    _conv(sd, "decoder.conv_out.conv", dec["conv_out"])
    _pointwise(sd, "quant_conv", params["quant_conv"])
    _pointwise(sd, "post_quant_conv", params["post_quant_conv"])
    return sd


def llama_state_dict_from_jax(params: Tree) -> StateDict:
    """models/text/llama.py tree -> LlamaModel state dict (HF keys)."""
    sd: StateDict = {"embed_tokens.weight":
                     _t(params["embed_tokens"]["embedding"])}
    for i in range(_depth(params["layers"])):
        p = _index(params["layers"], i)
        b = f"layers.{i}"
        _norm(sd, f"{b}.input_layernorm", p["input_layernorm"])
        for k in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _lin(sd, f"{b}.self_attn.{k}", p["self_attn"][k])
        _norm(sd, f"{b}.post_attention_layernorm",
              p["post_attention_layernorm"])
        for k in ("gate_proj", "up_proj", "down_proj"):
            _lin(sd, f"{b}.mlp.{k}", p["mlp"][k])
    _norm(sd, "norm", params["norm"])
    return sd


def clip_state_dict_from_jax(params: Tree) -> StateDict:
    """models/text/clip.py tree -> CLIPTextModel state dict (HF keys without
    the `text_model.` prefix)."""
    sd: StateDict = {
        "embeddings.token_embedding.weight":
            _t(params["token_embedding"]["embedding"]),
        "embeddings.position_embedding.weight":
            _t(params["position_embedding"]["embedding"]),
    }
    for i in range(_depth(params["layers"])):
        p = _index(params["layers"], i)
        b = f"encoder.layers.{i}"
        _norm(sd, f"{b}.layer_norm1", p["layer_norm1"])
        for k in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin(sd, f"{b}.self_attn.{k}", p["self_attn"][k])
        _norm(sd, f"{b}.layer_norm2", p["layer_norm2"])
        _lin(sd, f"{b}.mlp.fc1", p["mlp"]["fc1"])
        _lin(sd, f"{b}.mlp.fc2", p["mlp"]["fc2"])
    _norm(sd, "final_layer_norm", params["final_layer_norm"])
    return sd
