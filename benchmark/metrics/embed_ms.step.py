"""embed_ms.step: the DiT's conditioning and token embedders, device ms a
step: the `dit.embed` span of models/dit.py (time_in, vector_in,
guidance_in, img_in and the token refiner txt_in; one a forward, one
forward a step) in the traced steps, start to end on the card, over the
steps. The DiT rows that diffusion/pipeline.py's denoise_step counts must
be the cell's batch a step, len(text_valid): 1 in the guidance-distilled
mode, 2 under CFG. Moves step_s. None where the program logs no
`dit.embed` span."""
import bisect

from benchmark.spans import program

# the program's counter whose LAUNCHES (the DiT's batch rows) the trace is
# tied to
COUNTERS = {"dit_rows": "hunyuanvideo_efficiency_tpu_torch.diffusion."
                        "pipeline:denoise_step"}


def read(run):
    span = run.span
    if not span or span["units"] < 1 or run.trace is None:
        return None
    prof = program()
    if prof is None:
        return None
    t0, t1 = span["t0"], span["t1"]
    recs = prof.spans(t0, t1, "dit.embed")
    if not recs:
        return None
    rows = span["launches"]["dit_rows"]
    batch = len(run.shapes["text_valid"])
    if rows != batch * span["units"]:
        raise RuntimeError(f"embed_ms.step: {rows} DiT rows in "
                           f"{span['units']} steps, {batch} a step "
                           f"expected")
    steps = prof.spans(t0, t1, "step")
    if len(steps) != span["units"]:
        raise RuntimeError(f"embed_ms.step: {len(steps)} step spans in the "
                           f"window, {span['units']} steps marked")
    starts = [r.start_ns for r in recs]
    for s in steps:
        n = (bisect.bisect_left(starts, s.end_ns)
             - bisect.bisect_left(starts, s.start_ns))
        if n != 1:
            raise RuntimeError(f"embed_ms.step: {n} dit.embed spans in a "
                               f"step, 1 expected")
    if len(recs) != len(steps):
        raise RuntimeError(f"embed_ms.step: {len(recs)} dit.embed spans "
                           f"in the window, {len(steps)} inside its steps")
    return sum(r.device_ms for r in recs) / len(steps)
