"""PyTorch / CUDA port of the PLA streaming system (``repro``).

The JAX package ``repro`` stays the reference; this package mirrors its
layout (``core/``, ``kernels/``, ``data/``) and runs its hot path on
hand-written CUDA kernels for Hopper (``kernels/csrc/``), or on their plain
PyTorch versions for CPU tensors.  It imports ``torch`` and numpy, never
``jax`` and nothing of ``repro``.
"""
