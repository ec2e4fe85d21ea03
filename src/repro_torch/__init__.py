"""PyTorch/CUDA port of the parallel recursive-backtracking framework.

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``core/``, ``kernels/``, ``problems/``, ``registry``,
``solver``, ``service/``, ``obs/``, ``models/``, ``configs/``, ``serve/``,
``launch/``) and imports neither ``jax`` nor ``repro``.  Its
kernels are hand-written CUDA for Hopper (``kernels/csrc/``), built with
``nvcc`` at first use; on CPU tensors each kernel's plain PyTorch version
runs instead.
"""
