"""CUDA kernels, their plain PyTorch versions and the build (port of repro.kernels)."""
