"""Hand-written CUDA kernels (sources under ``csrc/``), their wrappers
and their plain PyTorch versions."""
