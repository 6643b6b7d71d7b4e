"""PyTorch/CUDA port of the HunyuanVideo efficiency stack (one-GPU text-to-video)."""
