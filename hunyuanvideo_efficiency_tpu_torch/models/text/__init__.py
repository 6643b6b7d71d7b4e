"""Text conditioning: Llama-3 LLM + CLIP-L towers and the TextEncoder wrapper
(reference: hyvideo/text_encoder/)."""
from .clip import CLIP_L, CLIPTextConfig, CLIPTextModel
from .encoder import (HashTokenizer, TextEncoder, TextEncoderOutput,
                      build_text_encoders)
from .llama import LLAMA3_8B, LlamaConfig, LlamaModel

__all__ = [
    "CLIP_L", "CLIPTextConfig", "CLIPTextModel", "HashTokenizer",
    "TextEncoder", "TextEncoderOutput", "build_text_encoders", "LLAMA3_8B",
    "LlamaConfig", "LlamaModel",
]
