"""vae_idle_ms.roundtrip: the VAE's launch-bound stretches, ms a round trip:
the device's idle gaps in the traced round trips' VAE parts whose midpoint
the host spent inside a `vae.encoder` or `vae.decoder` span
(models/vae.py), leaving out those in the profiler's own buffer flushes,
over the round trips. Moves roundtrip_s."""
from benchmark.spans import idle_ms


def read(run):
    if not run.span:
        return None
    return idle_ms(run, "vae_idle_ms.roundtrip", run.span["vae_parts"],
                   lambda name: name in ("vae.encoder", "vae.decoder"))
