"""glue_ms.step: the DiT step's glue, device ms a step: the traced steps'
device time in the frozen category() "other" bucket (elementwise, norms,
RoPE, modulate, copies, reductions), over the steps. Moves step_s."""
from benchmark.yardstick import GLUE


def read(run):
    span = run.span
    if not span or span["units"] < 1 or run.trace is None:
        return None
    cats = run.trace.by_category(span["t0"], span["t1"])
    return 1e3 * cats.get(GLUE, 0.0) / span["units"]
