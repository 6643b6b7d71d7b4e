"""device_idle.step: the share of the traced steps' wall time in which no
device operation ran (the union of their intervals), %. Moves step_s."""


def read(run):
    span = run.span
    if not span or span["units"] < 1 or run.trace is None:
        return None
    busy, _ = run.trace.busy_and_gaps(span["t0"], span["t1"])
    return 100.0 * (1.0 - busy / ((span["t1"] - span["t0"]) / 1e9))
