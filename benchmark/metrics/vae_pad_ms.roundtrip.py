"""vae_pad_ms.roundtrip: the VAE's causal pads, device ms a round trip: the
`vae.pad` spans of ops/conv3d.py:causal_conv3d (the edge-replicate gather
before every conv larger than 1x1x1) in the traced round trips' VAE parts,
over the round trips. Moves roundtrip_s."""
from benchmark.spans import trip_total


def read(run):
    return trip_total(run, "vae_pad_ms.roundtrip", "vae.pad")
