"""Multi-device and multi-process work (mirror of the JAX package's parallel/).

- ``mesh``: shard placement; shard k runs on card ``k mod n`` (every shard on
  ``cuda:0`` with one card, on ``cpu`` without one), or one shard per rank of
  a torch.distributed group;
- ``distributed``: ``init_distributed`` from the ``DROID_*`` variables, one
  process per card (NCCL), or gloo on the CPU; ``is_distributed``;
- ``dist_ba``: keyframe-sharded dense BA (``partition_edges``,
  ``dist_ba_solve``), each shard launching K1 once per iteration;
- ``train_parallel``: the data-parallel (+ fsdp) training step.
"""
from .dist_ba import dist_ba_solve, partition_edges, resolve_exchange
from .distributed import backend_for, init_distributed, is_distributed, rank_device
from .mesh import Mesh, local_device_count, local_devices, make_mesh
from .train_parallel import allreduce, make_parallel_train_step, shard_batch, shard_params_fsdp

__all__ = [k for k in dir() if not k.startswith("_")]
