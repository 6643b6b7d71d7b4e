"""vae_norm_ms.roundtrip: the VAE's GroupNorms, device ms a round trip: the
`vae.norm_act` spans of models/vae.py (each GroupNorm + SiLU of the resnet
blocks and the output norms, the mid attention's GroupNorm) in the traced
round trips' VAE parts, over the round trips. Moves roundtrip_s."""
from benchmark.spans import trip_total


def read(run):
    return trip_total(run, "vae_norm_ms.roundtrip", "vae.norm_act")
