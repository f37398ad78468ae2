"""Windowed dense bundle adjustment (Gauss-Newton + Schur) on tensors.

The per-edge blocks (the JAX package's ba/system.py::build_system_blocks)
live beside their CUDA kernel in ops/cuda_ba.py.
"""
from .solver import ba_iterations, schur_pairs

__all__ = [k for k in dir() if not k.startswith("_")]
