"""Models of the PyTorch port: the MM-DiT, the causal-3D VAE, the text towers."""
