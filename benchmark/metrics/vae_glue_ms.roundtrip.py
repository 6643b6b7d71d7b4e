"""vae_glue_ms.roundtrip: the VAE's glue, device ms a round trip: the
device time of the traced round trips' VAE parts (from each trip's start
to its synchronized reconstruction, so that the scores' work is left out)
outside K3, cuDNN and cuBLAS (the frozen category() "other" bucket:
GroupNorm, SiLU, the causal pads' gathers, the t-ops pools and repeats,
copies), over the round trips. Moves roundtrip_s."""
from benchmark.yardstick import GLUE


def read(run):
    span = run.span
    if not span or span["units"] < 1 or run.trace is None:
        return None
    glue = sum(run.trace.by_category(a, b).get(GLUE, 0.0)
               for a, b in span["vae_parts"])
    return 1e3 * glue / span["units"]
