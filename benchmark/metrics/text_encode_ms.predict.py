"""text_encode_ms.predict: the text towers' encoding of a predict(), device
ms: the window's one `text_encode` span (diffusion/pipeline.py:
encode_prompt, Llama-3-8B and CLIP-L over the prompt and the negative
prompt), start to end on the card. It lies inside the step_s window,
which starts before predict(), and before mark 0, with the window's first
step between them. Moves step_s."""
from benchmark import spans


def read(run):
    span = run.span
    if not span or run.trace is None:
        return None
    prof = spans.program()
    if prof is None:
        return None
    encs = prof.spans(0, span["t0"], "text_encode")
    if not encs:
        raise RuntimeError("text_encode_ms.predict: no text_encode span "
                           "before the window's first mark")
    enc = encs[-1]
    steps = prof.spans(enc.start_ns, span["t0"], "step")
    if len(steps) != 1:
        raise RuntimeError(f"text_encode_ms.predict: {len(steps)} steps "
                           f"between the text encoding and mark 0, 1 "
                           f"expected")
    return enc.device_ms
