"""TextEncoder: tokenization, prompt templates, crop_start, encode (JAX
counterpart: models/text/encoder.py; reference:
hyvideo/text_encoder/__init__.py:102-357).

"llm" wraps the Llama-3 tower (per-token hidden states tapped at
hidden_state_skip_layer), "clipL" the CLIP-L tower (pooled output). The
instruction template is applied around the prompt and its `crop_start`
hidden states are cut. `HashTokenizer` stands in where no HF tokenizer
files exist. quant="int8" stores the LLM's layer linears in int8 (W8A8,
JAX encoder.py:123-142); CLIP-L is never quantized.

A tensor-parallel LLM tower (`model.tp` set, models/text/llama.py; JAX
encoder.py:143-149) runs one collective forward over its ranks, which must
all feed it the same token ids and mask: rank 0's are broadcast before the
tower runs (the stand-in HashTokenizer hashes with a per-process salt).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ...constants import PROMPT_TEMPLATE
from ...ops.quantization import (Int8Linear, quantize_llama_int8,
                                 quantize_stack)
from .clip import CLIP_L, CLIPTextConfig, CLIPTextModel
from .llama import (LLAMA3_8B, LlamaConfig, LlamaModel, check_tp_divisible,
                    shard_llama_layer)


@dataclass
class TextEncoderOutput:
    """(reference: TextEncoderModelOutput, text_encoder/__init__.py:78-99)."""
    hidden_state: torch.Tensor
    attention_mask: Optional[torch.Tensor] = None


class HashTokenizer:
    """Deterministic stand-in tokenizer (whitespace + hash): fixed
    max_length, right padding, attention mask. `hash` of a str is salted
    per process, so ids agree only within one process."""

    def __init__(self, vocab_size: int, eos_token_id: Optional[int] = None,
                 bos_token_id: int = 1):
        self.vocab_size = vocab_size
        self.eos_token_id = eos_token_id or (vocab_size - 1)
        self.bos_token_id = bos_token_id

    def __call__(self, text, max_length: int = 256, **kw):
        texts = [text] if isinstance(text, str) else list(text)
        ids = np.zeros((len(texts), max_length), np.int32)
        mask = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            toks = [self.bos_token_id]
            for w in t.split():
                toks.append(2 + (hash(w) % (self.vocab_size - 3)))
            toks = toks[: max_length - 1] + [self.eos_token_id]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def load_hf_tokenizer(tokenizer_type: str, path: str):
    """(reference: load_tokenizer, text_encoder/__init__.py:58-75)."""
    if tokenizer_type == "clipL":
        from transformers import CLIPTokenizer

        return CLIPTokenizer.from_pretrained(path, max_length=77)
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path, padding_side="right")


class TextEncoder:
    def __init__(
        self,
        text_encoder_type: str,
        max_length: int,
        model: Union[LlamaModel, CLIPTextModel],
        tokenizer=None,
        prompt_template: Optional[dict] = None,
        prompt_template_video: Optional[dict] = None,
        hidden_state_skip_layer: Optional[int] = None,
        apply_final_norm: bool = False,
        use_attention_mask: bool = True,
        quant: Optional[str] = None,
    ):
        if text_encoder_type not in ("llm", "clipL"):
            raise ValueError(
                f"Unsupported text encoder type: {text_encoder_type}")
        if quant not in (None, "int8"):
            raise ValueError(f"text encoder quant must be int8|None: {quant}")
        for tpl, nm in ((prompt_template, "prompt_template"),
                        (prompt_template_video, "prompt_template_video")):
            if tpl is not None and not (isinstance(tpl, dict)
                                        and "{}" in str(tpl.get("template"))):
                raise ValueError(f"`{nm}` must be a dict whose 'template' "
                                 f"contains {{}}")
        self.text_encoder_type = text_encoder_type
        self.max_length = max_length
        self.quant = quant if text_encoder_type == "llm" else None
        if self.quant == "int8" and not isinstance(
                model.layers[0].self_attn.q_proj, Int8Linear):
            if model.tp is not None:
                raise ValueError("int8 for a tensor-parallel Llama tower: "
                                 "quantize before the split (a row-parallel "
                                 "slice keeps the whole row's scale_out)")
            quantize_llama_int8(model)
        self.model = model
        self.prompt_template = prompt_template
        self.prompt_template_video = prompt_template_video
        self.use_template = prompt_template is not None
        self.hidden_state_skip_layer = hidden_state_skip_layer
        self.apply_final_norm = apply_final_norm
        self.use_attention_mask = use_attention_mask
        if tokenizer is None:
            cfg = model.cfg
            eos = (cfg.eos_token_id if isinstance(cfg, CLIPTextConfig)
                   else None)
            tokenizer = HashTokenizer(cfg.vocab_size, eos_token_id=eos)
        self.tokenizer = tokenizer

    @property
    def device(self):
        return next(self.model.parameters()).device

    def _template(self, data_type: str):
        tpl = (self.prompt_template if data_type == "image"
               else self.prompt_template_video)
        if tpl is None:
            raise ValueError(f"Unsupported data type: {data_type}")
        return tpl

    def text2tokens(self, text, data_type: str = "image"):
        """(reference: text2tokens, :217-269)."""
        if self.use_template:
            template = self._template(data_type)["template"]
            text = ([template.format(t) for t in text]
                    if isinstance(text, (list, tuple))
                    else template.format(text))
        if isinstance(self.tokenizer, HashTokenizer):
            enc = self.tokenizer(text, max_length=self.max_length)
        else:
            enc = self.tokenizer(text, truncation=True,
                                 max_length=self.max_length,
                                 padding="max_length",
                                 return_attention_mask=True,
                                 return_tensors="np")
        dev = self.device
        return {"input_ids": torch.as_tensor(
                    np.asarray(enc["input_ids"]), dtype=torch.long,
                    device=dev),
                "attention_mask": torch.as_tensor(
                    np.asarray(enc["attention_mask"]), dtype=torch.long,
                    device=dev)}

    def encode(self, batch_encoding, data_type: str = "image"
               ) -> TextEncoderOutput:
        """(reference: encode, :271-338)."""
        ids = batch_encoding["input_ids"]
        mask = batch_encoding["attention_mask"]
        tp = getattr(self.model, "tp", None)
        if tp is not None:      # one collective forward: rank 0's tokens
            ids, mask = tp.broadcast0(ids), tp.broadcast0(mask)
        fwd_mask = mask if self.use_attention_mask else None
        if self.text_encoder_type == "clipL":
            _, pooled = self.model.encode(ids, fwd_mask)
            return TextEncoderOutput(pooled, None)
        hidden = self.model.encode(ids, fwd_mask,
                                   self.hidden_state_skip_layer or 0,
                                   self.apply_final_norm)
        if self.use_template:
            crop = self._template(data_type).get("crop_start", -1)
            if crop > 0:
                hidden, mask = hidden[:, crop:], mask[:, crop:]
        return TextEncoderOutput(hidden,
                                 mask if self.use_attention_mask else None)

    def encode_prompt(self, prompt, data_type: str = "video",
                      num_videos: int = 1
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(embeds, mask), each repeated per video."""
        out = self.encode(self.text2tokens(prompt, data_type), data_type)
        pe = out.hidden_state.repeat_interleave(num_videos, dim=0)
        mask = (out.attention_mask.repeat_interleave(num_videos, dim=0)
                if out.attention_mask is not None else None)
        return pe, mask


def _build(model_cls, cfg, device, dtype, generator, state_dict=None):
    with torch.device("meta"):
        model = model_cls(cfg, dtype=dtype)
    model = model.to_empty(device=device).eval().requires_grad_(False)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    elif generator is not None:
        model.init_weights(generator)
    return model


@torch.no_grad()
def build_llama_tp(cfg: LlamaConfig, comm, device, dtype,
                   generator: Optional[torch.Generator] = None,
                   state_dict: Optional[dict] = None,
                   quant: Optional[str] = None) -> LlamaModel:
    """This rank's shard of the Llama tower over `comm`, built one layer at
    a time on `device` (the whole tower is never resident): each module
    takes its weights (from `state_dict`, else random from `generator` in
    the order of LlamaModel.init_weights, so the values equal the one-rank
    build's), a layer is quantized (quant="int8") and then cut to its
    slices."""
    check_tp_divisible(cfg, comm.world)
    with torch.device("meta"):
        model = LlamaModel(cfg, dtype=dtype)
    model.eval().requires_grad_(False)
    for name, child in model.named_children():
        mods = list(child) if name == "layers" else [child]
        for i, mod in enumerate(mods):
            prefix = f"{name}.{i}." if name == "layers" else f"{name}."
            mod.to_empty(device=device)
            if state_dict is not None:
                mod.load_state_dict({k[len(prefix):]: v for k, v in
                                     state_dict.items()
                                     if k.startswith(prefix)})
            elif generator is not None:
                # LlamaModel.init_weights on this module alone: the same
                # draws in the same order
                LlamaModel.init_weights(mod, generator)
            if name == "layers":
                if quant == "int8":
                    quantize_stack(mod, int8=True)
                shard_llama_layer(mod, comm)
    model.tp = comm
    return model


def build_text_encoders(
    *,
    llm_config: Optional[LlamaConfig] = None,
    clip_config: Optional[CLIPTextConfig] = None,
    tokenizer_path: Optional[str] = None,
    tokenizer_path_2: Optional[str] = None,
    text_len: int = 256,
    text_len_2: int = 77,
    prompt_template: str = "dit-llm-encode",
    prompt_template_video: str = "dit-llm-encode-video",
    hidden_state_skip_layer: int = 2,
    apply_final_norm: bool = False,
    device="cuda",
    dtype=torch.float16,
    generator: Optional[torch.Generator] = None,
    llm_quant: Optional[str] = None,
    llm_state_dict: Optional[dict] = None,
    clip_state_dict: Optional[dict] = None,
    llm_comm=None,
) -> Tuple[TextEncoder, TextEncoder]:
    """The (llm, clipL) pair as Inference.from_pretrained builds it
    (reference: hyvideo/inference.py:210-264); the LLM max_length includes
    the template's crop_start. A tower's weights come from its state dict
    when given (the port's key names), else random from `generator` when
    given, else uninitialized; llm_quant="int8" quantizes the LLM's layer
    linears after its weights are in. With `llm_comm` (parallel.comm.
    GroupComm) the LLM is this rank's tensor-parallel shard, built a layer
    at a time (build_llama_tp)."""
    tpl = PROMPT_TEMPLATE.get(prompt_template)
    tpl_video = PROMPT_TEMPLATE.get(prompt_template_video)
    crop = max(tpl_video.get("crop_start", 0) if tpl_video else 0,
               tpl.get("crop_start", 0) if tpl else 0)
    if llm_comm is not None:
        llm_model = build_llama_tp(llm_config or LLAMA3_8B, llm_comm,
                                   device, dtype, generator, llm_state_dict,
                                   llm_quant)
    else:
        llm_model = _build(LlamaModel, llm_config or LLAMA3_8B, device,
                           dtype, generator, llm_state_dict)
    clip_model = _build(CLIPTextModel, clip_config or CLIP_L, device, dtype,
                        generator, clip_state_dict)
    llm = TextEncoder(
        "llm", text_len + crop, llm_model,
        tokenizer=(load_hf_tokenizer("llm", tokenizer_path)
                   if tokenizer_path else None),
        prompt_template=tpl, prompt_template_video=tpl_video,
        hidden_state_skip_layer=hidden_state_skip_layer,
        apply_final_norm=apply_final_norm, quant=llm_quant)
    clip = TextEncoder(
        "clipL", text_len_2, clip_model,
        tokenizer=(load_hf_tokenizer("clipL", tokenizer_path_2)
                   if tokenizer_path_2 else None))
    return llm, clip
