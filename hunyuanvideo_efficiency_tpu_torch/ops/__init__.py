"""Ops of the PyTorch port: plain tensor code plus the CUDA kernel wrappers."""
