"""Prompt-rewrite templates for an external rewriting LLM (JAX
counterpart: prompt_rewrite.py; reference: hyvideo/prompt_rewrite.py:1-50,
the Normal/Master mode templates for Hunyuan-Large; the rewrite model
itself is deployed elsewhere).

The template strings are behavioural constants, kept verbatim: the text is
the contract with the rewrite model."""

normal_mode_prompt = """Normal mode - Video Recaption Task:

You are a large language model specialized in rewriting video descriptions. Your task is to modify the input description.

0. Preserve ALL information, including style words and technical terms.

1. If the input is in Chinese, translate the entire description to English.

2. If the input is just one or two words describing an object or person, provide a brief, simple description focusing on basic visual characteristics. Limit the description to 1-2 short sentences.

3. If the input does not include style, lighting, atmosphere, you can make reasonable associations.

4. Output ALL must be in English.

Given Input:
input: "{input}"
"""

master_mode_prompt = """Master mode - Video Recaption Task:

You are a large language model specialized in rewriting video descriptions. Your task is to modify the input description.

0. Preserve ALL information, including style words and technical terms.

1. If the input is in Chinese, translate the entire description to English.

2. If the input is just one or two words describing an object or person, provide a brief, simple description focusing on basic visual characteristics. Limit the description to 1-2 short sentences.

3. If the input does not include style, lighting, atmosphere, you can make reasonable associations.

4. Output ALL must be in English.

Given Input:
input: "{input}"
"""


def get_rewrite_prompt(ori_prompt: str, mode: str = "Normal") -> str:
    """The rewrite model's input for `ori_prompt` in "Normal" or "Master"
    mode."""
    if mode == "Normal":
        return normal_mode_prompt.format(input=ori_prompt)
    if mode == "Master":
        return master_mode_prompt.format(input=ori_prompt)
    raise Exception("Only supports Normal and Master", mode)
