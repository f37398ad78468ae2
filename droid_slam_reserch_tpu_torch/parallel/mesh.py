"""Shard placement (mirror of the JAX package's parallel/mesh.py).

A JAX ``Mesh`` puts one shard on each device.  The port places shard k on
``devices[k % len(devices)]``: on a host with n cards shard k runs on card
``k mod n``, on one card every shard runs on ``cuda:0``, and on the CPU
every shard runs on ``cpu``.  Shards that share a device run one after the
other in shard order, so an explicit shard count runs its partitioning, its
per-shard kernels and its exchange on any host.
"""
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


def local_devices(device=None):
    """The devices this process places shards on: every visible card for a
    CUDA `device` (the default when a card is visible), else the CPU."""
    device = torch.device(device if device is not None
                          else "cuda" if torch.cuda.is_available() else "cpu")
    if device.type == "cuda":
        return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    return [device]


def local_device_count(device=None):
    """The JAX package's ``jax.local_device_count()`` for the auto shard
    rules: the visible cards for a CUDA `device`, 1 for the CPU."""
    return len(local_devices(device))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Shards along one named axis.  ``devices[k]`` is the device of shard
    ``shards[k]``, for the shards this process holds: all of them in process,
    or this rank's one when ``group`` (a torch.distributed group with one
    shard per rank) is set."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]
    shards: Tuple[int, ...]
    group: Optional[object] = None

    @property
    def size(self):
        return int(np.prod(self.shape))


def make_mesh(shape=None, axis_names=("dp",), devices=None, group=None):
    """The shards of `shape` (default: one per device) placed on `devices`
    (default: ``local_devices()``) by shard k -> devices[k % len(devices)].

    With a torch.distributed `group`, the mesh has one shard per rank and
    this process holds the shard of its rank, on ``cuda:{rank % n}`` of its n
    visible cards (or the first of `devices`' kind), else the CPU.
    """
    devices = [torch.device(d) for d in (devices if devices is not None else local_devices())]
    if group is not None:
        import torch.distributed as dist

        rank, world = dist.get_rank(group), dist.get_world_size(group)
        shape = tuple(shape) if shape is not None else (world,)
        if int(np.prod(shape)) != world:
            raise ValueError(f"a mesh over a group of {world} ranks has {world} shards, "
                             f"not shape {shape}")
        return Mesh(shape, tuple(axis_names), (devices[rank % len(devices)],), (rank,), group)
    shape = tuple(shape) if shape is not None else (len(devices),)
    n = int(np.prod(shape))
    return Mesh(shape, tuple(axis_names), tuple(devices[k % len(devices)] for k in range(n)),
                tuple(range(n)))
