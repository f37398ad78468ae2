"""Multi-process start-up (mirror of the JAX package's parallel/distributed.py).

The reference trains with one process per GPU, joined by NCCL (reference
train.py:28-36).  So does the port: one process drives one card, and rank r
uses ``cuda:{r mod n}`` of the n cards it sees.  The processes meet at a
TCP address given by the same variables as the JAX package's:

    DROID_COORDINATOR    host:port of rank 0   (e.g. "10.0.0.1:8476")
    DROID_NUM_PROCESSES  the number of ranks (processes, one card each)
    DROID_PROCESS_ID     this process's rank

``init_distributed`` joins the group over the backend it is given
(``backend_for``: NCCL for CUDA, gloo for the CPU); it does nothing when neither arguments nor variables ask for more
than one process, and is safe to call twice.
"""
import os

import torch


def _env_int(name):
    return int(os.environ[name]) if name in os.environ else None


def backend_for(device):
    """The process group's backend for ranks that compute on `device`:
    "nccl" for CUDA, "gloo" otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(coordinator=None, num_processes=None, process_id=None, *, backend):
    """Join (or start) the group of ranks over `backend` ("nccl" or
    "gloo", see ``backend_for``).  Returns (rank, world_size): (0, 1) when
    no group is asked for.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coordinator = coordinator or os.environ.get("DROID_COORDINATOR")
    num_processes = num_processes if num_processes is not None else _env_int("DROID_NUM_PROCESSES")
    process_id = process_id if process_id is not None else _env_int("DROID_PROCESS_ID")
    if not (coordinator or num_processes):
        return 0, 1
    if not coordinator or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs DROID_COORDINATOR, DROID_NUM_PROCESSES "
                         "and DROID_PROCESS_ID (or the three arguments)")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes), rank=int(process_id))
    return dist.get_rank(), dist.get_world_size()


def is_distributed():
    """True when this process is one of several ranks of an initialised
    torch.distributed group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def rank_device(device="cuda"):
    """This rank's device: ``cuda:{rank mod n}`` for a CUDA `device`, else
    `device` itself."""
    import torch.distributed as dist

    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or not torch.cuda.device_count():
        return device
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())
