"""Dense bundle adjustment (Gauss-Newton + Schur) on tensors.

- ``solver``: the engine's windowed BA; its per-edge blocks (the JAX
  package's ba/system.py::build_system_blocks) are K1, beside its CUDA
  kernel in ops/cuda_ba.py;
- ``system``, ``chol``, ``dense``: the training BA, batched and
  differentiable: per-edge blocks, failure-tolerant Cholesky solves with
  the upstream backward, and the ``BA`` / ``MoBA`` steps.
"""
from .chol import block_solve, cholesky_solve_safe, schur_solve
from .dense import BA, MoBA
from .solver import ba_iterations, schur_pairs
from .system import build_system_blocks

__all__ = [k for k in dir() if not k.startswith("_")]
