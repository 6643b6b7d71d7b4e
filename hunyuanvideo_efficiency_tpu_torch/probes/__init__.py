"""On-card probes: timing entry points for single kernels at real shapes
(the counterparts of the JAX package's scripts/conv_probe.py and
scripts/sta_kernel_bench.py). Each needs a CUDA device."""
