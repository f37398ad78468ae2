"""Data-parallel (+ fsdp) training over torch.distributed (mirror of the
JAX package's parallel/train_parallel.py).

The ranks of a group form a (dp, fsdp) mesh (``make_mesh(shape,
("dp", "fsdp"), group=...)``, row-major over the ranks): the batch is split
over ``dp``; each parameter and its Adam moments are split over ``fsdp``
along ``_fsdp_spec``'s axis (replicated where no axis divides).  A step
all-gathers the parameters' slices, runs the forward and backward on the
rank's batch with its loss scaled by its share of the global batch, sums
the gradients over the dp ranks with bucketed all_reduces (DDP's backward
averages instead: here the update operator's heads zero gradient entries
above 0.01, so the scaling must come before the backward for the step to
be the global batch's; the parameters are a dict of tensors, not a
module), and updates only the rank's slices.  The clip to the global norm
sums the squares over every slice.
"""
import numpy as np
import torch

BUCKET_BYTES = 25 * 2**20        # DDP's default bucket


def _fsdp_spec(shape, n):
    """Shard the largest axis divisible by n; replicate otherwise.  The
    spec is a tuple like a JAX PartitionSpec: "fsdp" at the sharded axis,
    None elsewhere, () when replicated."""
    best = None
    for i, d in enumerate(shape):
        if d % n == 0 and d >= n and (best is None or d > shape[best]):
            best = i
    if best is None:
        return ()
    spec = [None] * len(shape)
    spec[best] = "fsdp"
    return tuple(spec)


def _axis_size(mesh, name):
    return mesh.shape[mesh.axis_names.index(name)] if name in mesh.axis_names else 1


class MeshAxes:
    """This rank's place on the (dp, fsdp) axes of `mesh` and the groups of
    ranks along each axis (torch.distributed groups; None when the mesh has
    no group and a single shard)."""

    def __init__(self, mesh):
        import torch.distributed as dist

        if mesh.group is None and mesh.size != 1:
            raise ValueError("training over several shards runs one process per rank: "
                             "make the mesh with a torch.distributed group")
        self.mesh, self.device = mesh, mesh.devices[0]
        self.dp, self.fsdp = _axis_size(mesh, "dp"), _axis_size(mesh, "fsdp")
        if self.dp * self.fsdp != mesh.size:
            raise ValueError(f"mesh axes {mesh.axis_names} {mesh.shape}: only dp and fsdp")
        coords = np.unravel_index(mesh.shards[0], mesh.shape)
        self.dp_index = int(coords[mesh.axis_names.index("dp")]) if self.dp > 1 else 0
        self.fsdp_index = int(coords[mesh.axis_names.index("fsdp")]) if self.fsdp > 1 else 0
        self.dp_group = self.fsdp_group = None
        if mesh.group is not None:
            ranks = np.arange(mesh.size).reshape(mesh.shape)
            to_global = [dist.get_global_rank(mesh.group, int(r)) for r in range(mesh.size)]
            for name in ("dp", "fsdp"):
                if name not in mesh.axis_names:
                    continue
                ax = mesh.axis_names.index(name)
                lines = np.moveaxis(ranks, ax, -1).reshape(-1, mesh.shape[ax])
                for line in lines:    # every rank makes every group, in one order
                    if len(line) == mesh.size:
                        g = mesh.group
                    elif len(line) == 1:
                        g = None
                    else:
                        g = dist.new_group([to_global[int(r)] for r in line])
                    if mesh.shards[0] in line:
                        setattr(self, f"{name}_group", g)

    def shard(self, x):
        """This rank's fsdp slice of a full tensor, on the rank's device."""
        spec = _fsdp_spec(tuple(x.shape), self.fsdp)
        x = x.to(self.device)
        if "fsdp" not in spec:
            return x.clone()
        return x.chunk(self.fsdp, dim=spec.index("fsdp"))[self.fsdp_index].clone()

    def gather(self, full_shape, x):
        """The full tensor of shape full_shape from this rank's slice x."""
        spec = _fsdp_spec(tuple(full_shape), self.fsdp)
        if "fsdp" not in spec or self.fsdp_group is None:
            return x
        import torch.distributed as dist

        parts = [torch.empty_like(x) for _ in range(self.fsdp)]
        dist.all_gather(parts, x.contiguous(), group=self.fsdp_group)
        return torch.cat(parts, dim=spec.index("fsdp"))

    def sq_norm(self, full_shapes):
        """The squared global norm of a dict of gradient slices: each
        sharded parameter's squares summed over its fsdp slices, each
        replicated one's counted once; summed in the dict's order."""
        import torch.distributed as dist

        def sq(grads):
            keys = list(grads)
            local = torch.stack([torch.sum(grads[k] * grads[k]) for k in keys])
            sharded = torch.tensor(["fsdp" in _fsdp_spec(tuple(full_shapes[k]), self.fsdp)
                                    for k in keys], device=local.device)
            if self.fsdp_group is not None:
                total = torch.where(sharded, local, torch.zeros_like(local))
                dist.all_reduce(total, group=self.fsdp_group)
                local = torch.where(sharded, total, local)
            return sum(local.unbind())

        return sq


def allreduce(tensors, group, divide=1):
    """{k: sum over the ranks of `group`, divided by `divide`} of a dict of
    tensors, by all_reduces of flat buckets of about BUCKET_BYTES each, in
    the dict's order (DDP's bucketed gradient reduction)."""
    import torch.distributed as dist

    keys = list(tensors)
    out, bucket, size = {}, [], 0

    def flush():
        flat = torch.cat([tensors[k].reshape(-1) for k in bucket])
        dist.all_reduce(flat, group=group)
        if divide != 1:
            flat = flat / divide
        for k, part in zip(bucket, flat.split([tensors[k].numel() for k in bucket])):
            out[k] = part.view_as(tensors[k])

    for k in keys:
        bucket.append(k)
        size += tensors[k].numel() * tensors[k].element_size()
        if size >= BUCKET_BYTES:
            flush()
            bucket, size = [], 0
    if bucket:
        flush()
    return {k: out[k] for k in keys}


def _axes(mesh):
    return mesh if isinstance(mesh, MeshAxes) else MeshAxes(mesh)


def shard_params_fsdp(params, mesh):
    """This rank's slices of a parameter dict (replicated where no axis
    divides), on its device.  mesh: a Mesh, or its MeshAxes (which made
    the groups once)."""
    ax = _axes(mesh)
    return {k: ax.shard(v) for k, v in params.items()}


def shard_batch(batch, mesh):
    """This rank's part of the leading (batch) axis of every entry, split
    over dp, on its device; mesh as shard_params_fsdp's."""
    ax = _axes(mesh)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % ax.dp:
            raise ValueError(f"batch entry {k!r} of {v.shape[0]} items does not split over "
                             f"{ax.dp} dp ranks")
        out[k] = v.chunk(ax.dp, dim=0)[ax.dp_index].to(ax.device)
    return out


def make_parallel_train_step(cfg, ii, jj, mesh, num_steps=None, dtype=None, remat=False):
    """Returns (step, prepare), prepare shards params/opt/batch.

    step(params, opt_state, batch) -> (params, opt_state, metrics) takes
    this rank's slices and batch (from prepare) and returns its new slices;
    the metrics are averaged over the dp ranks; the step computes what one
    process computes on the whole batch, up to the order of the sums.  dtype/remat pass through to
    the training loss, as make_train_step's.
    """
    from ..train.step import fixed_graph_loss, grads_and_aux, make_optimizer

    ax = MeshAxes(mesh)
    ii, jj = (torch.as_tensor(x).to(ax.device, torch.long) for x in (ii, jj))
    loss_fn = fixed_graph_loss(cfg, ii, jj, num_steps, dtype, remat)
    shapes = {}

    def prepare(params, opt_state, batch):
        shapes.update({k: tuple(v.shape) for k, v in params.items()})
        opt = {"count": opt_state["count"],
               "mu": {k: ax.shard(v) for k, v in opt_state["mu"].items()},
               "nu": {k: ax.shard(v) for k, v in opt_state["nu"].items()}}
        return shard_params_fsdp(params, ax), opt, shard_batch(batch, ax)

    def step(params, opt_state, batch):
        if not shapes:
            raise RuntimeError("call prepare before the first step")
        full = {k: ax.gather(shapes[k], v) for k, v in params.items()}
        # each rank's share of the global batch's loss, gradients summed
        grads, metrics = grads_and_aux(loss_fn, full, batch, 1.0 / ax.dp)
        if ax.dp_group is not None:
            grads = allreduce(grads, ax.dp_group)
            metrics = allreduce(metrics, ax.dp_group, ax.dp)
        grads = {k: ax.shard(g) for k, g in grads.items()}
        params, opt_state = update(params, opt_state, grads)
        return params, opt_state, metrics

    update = make_optimizer(cfg, sq_norm=ax.sq_norm(shapes))
    return step, prepare
