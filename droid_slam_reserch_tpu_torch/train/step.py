"""The training step (mirror of the JAX package's train/step.py).

The unrolled forward (iterations of correlation lookup, update and 2 dense
BA steps) is differentiated end to end by autograd, through the Cholesky
solves' backward (ba/chol.py).  No counted kernel wrapper runs here: the
engine's kernels have no backward.

Parameters are a dict of fp32 tensors under the port's state_dict names;
the optimizer is optax's chain, written out: non-finite gradient entries
zeroed, a clip to global norm ``cfg.clip``, then AdamW (eps outside the
square root, decoupled weight decay) on a torch-exact OneCycle schedule
read at the step count before it is incremented.
"""
import math

import numpy as np
import torch
from torch.func import functional_call

from ..geom.graph_utils import build_frame_graph, graph_to_edge_list
from ..geom.losses import flow_loss, geodesic_loss, residual_loss
from ..lie import se3_inv
from ..models.droidnet import DroidNet, init_params

B1, B2, EPS = 0.9, 0.999, 1e-8          # optax.adamw's defaults


def onecycle_schedule(total_steps, peak_value, pct_start, div_factor=25.0,
                      final_div_factor=1e4):
    """torch's OneCycleLR with cosine annealing, as a function of the step
    count: the warmup ends at step pct_start * total_steps - 1 and the
    anneal at total_steps - 1."""
    initial = peak_value / div_factor
    min_lr = initial / final_div_factor
    warm_end = pct_start * total_steps - 1.0
    anneal_end = total_steps - 1.0

    def _cos(a, b, pct):
        return b + (a - b) / 2.0 * (1.0 + math.cos(math.pi * pct))

    def schedule(count):
        count = float(count)
        if count <= warm_end:
            return _cos(initial, peak_value, min(max(count / max(warm_end, 1e-6), 0.0), 1.0))
        ap = min(max((count - warm_end) / max(anneal_end - warm_end, 1e-6), 0.0), 1.0)
        return _cos(peak_value, min_lr, ap)

    return schedule


def make_schedule(cfg):
    """The OneCycle schedule of cfg, its total steps floored so that the
    warmup spans at least one step (short runs)."""
    steps = max(cfg.steps, int(math.ceil(1.0 / max(cfg.pct_start, 1e-6))) + 1)
    return onecycle_schedule(total_steps=steps, peak_value=cfg.lr, pct_start=cfg.pct_start)


def sanitize(grads):
    """Zero non-finite gradient entries: the global-norm clip couples every
    parameter through one norm, so one NaN would reach all of them."""
    return {k: torch.where(torch.isfinite(g), g, torch.zeros_like(g)) for k, g in grads.items()}


def squares(grads):
    """The squared global norm of a gradient dict."""
    return sum(torch.sum(g * g) for g in grads.values())


def clip_by_global_norm(grads, clip, sq_norm=squares):
    """optax.clip_by_global_norm: g where the global norm is under clip,
    else (g / norm) * clip (chosen on the device, no host read).  sq_norm
    gives the squared global norm (parallel/train_parallel.py sums it over
    the slices of sharded parameters)."""
    norm = torch.sqrt(sq_norm(grads))
    keep = norm < clip
    return {k: torch.where(keep, g, (g / norm) * clip) for k, g in grads.items()}


def init_opt_state(params):
    """AdamW's state: moments like the parameters, and the step count."""
    return {"count": 0, "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()}}


def make_optimizer(cfg, sq_norm=squares):
    """update(params, opt_state, grads) -> (params, opt_state); sq_norm as
    clip_by_global_norm's."""
    schedule = make_schedule(cfg)
    wd = cfg.weight_decay

    @torch.no_grad()
    def update(params, opt_state, grads):
        grads = clip_by_global_norm(sanitize(grads), cfg.clip, sq_norm)
        count = opt_state["count"]
        lr = schedule(count)
        c1, c2 = 1.0 - B1 ** (count + 1), 1.0 - B2 ** (count + 1)
        new_p, mu, nu = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            mu[k] = (1.0 - B1) * g + B1 * opt_state["mu"][k]
            nu[k] = (1.0 - B2) * (g * g) + B2 * opt_state["nu"][k]
            u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + EPS)
            u = (u + wd * p) * -lr
            new_p[k] = p + u
        return new_p, {"count": count + 1, "mu": mu, "nu": nu}

    return update


def init_train_state(cfg, seed=0, device="cuda"):
    """Seeded random parameters (``init_params``) on `device`, and a fresh
    optimizer state."""
    params = {k: v.to(device) for k, v in init_params(seed).items()}
    return params, init_opt_state(params)


def initial_poses(Ps):
    """The pose initialisation: frame 0 at its ground truth, every other
    frame at frame 1's."""
    return torch.cat([Ps[:, :1], Ps[:, 1:2].expand(-1, Ps.shape[1] - 1, -1)], dim=1)


def _losses(cfg, Ps, batch, poses_est, disps_est, residuals, ii, jj, emask):
    geo, geo_m = geodesic_loss(Ps, poses_est, ii, jj, do_scale=False, edge_mask=emask)
    res, res_m = residual_loss(residuals, edge_mask=emask)
    flo, flo_m = flow_loss(Ps, batch["disps"], poses_est, disps_est, batch["intrinsics"])
    loss = cfg.w1 * geo + cfg.w2 * res + cfg.w3 * flo
    metrics = {"loss": loss.detach(), "geo": geo.detach(), "res": res.detach(),
               "flow": flo.detach()}
    metrics.update(geo_m)
    metrics.update(res_m)
    metrics.update(flo_m)
    return loss, metrics


class _Model:
    """The DroidNet skeleton the parameters are swapped into, and the
    network's compute dtype (bf16: the parameters are cast for the call,
    and their gradients come back in fp32)."""

    def __init__(self, remat, dtype):
        self.net = DroidNet(remat=remat)
        self.dtype = dtype

    def __call__(self, params, *args, **kw):
        if self.dtype is not None:
            params = {k: v.to(self.dtype) for k, v in params.items()}
        return functional_call(self.net, params, args, kw)


def grads_and_aux(loss_fn, params, batch, loss_scale=1.0):
    """(grads, aux) of loss_scale * loss_fn(params, batch)[0] with respect to
    params; aux is loss_fn's second output.

    loss_scale: a data-parallel rank's share of the global batch.  The
    update operator's heads zero gradient entries above 0.01
    (models/layers.py), so the gradients of a global batch are not the mean
    of its parts' gradients: each rank scales its loss before the backward,
    and the ranks' gradients are summed."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss, aux = loss_fn(leaves, batch)
    if loss_scale != 1.0:
        loss = loss * loss_scale
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads)), aux


def fixed_graph_loss(cfg, ii, jj, num_steps=None, dtype=None, remat=False):
    """loss_fn(params, batch) -> (loss, metrics) on a fixed graph (ii, jj
    long tensors), from the ground-truth initialisation (initial_poses,
    disparities 1).

    batch: images [B,P,H,W,3] BGR 0-255, poses [B,P,7] world-to-camera,
    disps [B,P,H,W] ground-truth inverse depth, intrinsics [B,P,4] at full
    resolution.  dtype: the network's compute dtype (None: fp32); remat:
    see DroidNet.
    """
    model = _Model(remat, dtype)
    num_steps = num_steps or cfg.iters

    def loss_fn(params, batch):
        Ps = se3_inv(batch["poses"])
        disp0 = torch.ones_like(batch["disps"][:, :, 3::8, 3::8])
        poses_est, disps_est, residuals = model(
            params, initial_poses(Ps), batch["images"], disp0, batch["intrinsics"] / 8.0,
            ii, jj, num_steps, 2)
        return _losses(cfg, Ps, batch, poses_est, disps_est, residuals, ii, jj, None)

    return loss_fn


def sampled_graph_loss(cfg, num_steps=None, dtype=None, remat=False):
    """loss_fn(params, batch) -> (loss, (metrics, carry)) for per-item
    sampled graphs: the graph and the initialisation travel in the batch
    (see make_train_step_dynamic); carry is the last iteration's poses and
    1/8-resolution disparities, detached."""
    model = _Model(remat, dtype)
    num_steps = num_steps or cfg.iters

    def loss_fn(params, batch):
        Ps = se3_inv(batch["poses"])
        ii, jj, emask = batch["ii"], batch["jj"], batch["emask"]
        poses_est, disps_est, residuals = model(
            params, batch["Gs0"], batch["images"], batch["disp0"], batch["intrinsics"] / 8.0,
            ii, jj, num_steps, 2, edge_mask=emask)
        loss, metrics = _losses(cfg, Ps, batch, poses_est, disps_est, residuals, ii, jj, emask)
        carry = (poses_est[-1].detach(), disps_est[-1][:, :, 3::8, 3::8].detach())
        return loss, (metrics, carry)

    return loss_fn


def make_train_step(cfg, ii, jj, num_steps=None, dtype=None, remat=False):
    """step(params, opt_state, batch) -> (params, opt_state, metrics) on a
    fixed graph (see fixed_graph_loss)."""
    loss_fn = fixed_graph_loss(cfg, ii, jj, num_steps, dtype, remat)
    opt = make_optimizer(cfg)

    def step(params, opt_state, batch):
        grads, metrics = grads_and_aux(loss_fn, params, batch)
        params, opt_state = opt(params, opt_state, grads)
        return params, opt_state, metrics

    return step


def make_train_step_dynamic(cfg, num_steps=None, dtype=None, remat=False, loss_scale=1.0):
    """The training step for per-item sampled graphs and pose restarts.

    The graph and the initialisation travel in the batch: {images, poses,
    disps, intrinsics, ii [E] long, jj [E] long, emask [E] float, Gs0
    [B,P,7], disp0 [B,P,H/8,W/8]}.  Returns (grad_step, apply_step):

    - grad_step(params, batch) -> (grads, metrics, (Gs_last, disp_last)):
      one forward and backward pass; the carry re-seeds Gs0 and disp0 for a
      restart, whose gradients are summed before one optimizer step;
    - apply_step(params, opt_state, grads) -> (params, opt_state).

    loss_scale: see grads_and_aux (1 / world size on each of several ranks).
    """
    loss_fn = sampled_graph_loss(cfg, num_steps, dtype, remat)

    def grad_step(params, batch):
        grads, (metrics, carry) = grads_and_aux(loss_fn, params, batch, loss_scale)
        return grads, metrics, carry

    return grad_step, make_optimizer(cfg)


def temporal_graph(n_frames, r=2):
    """Every ordered pair of distinct frames at most r apart."""
    pairs = [(i, j) for i in range(n_frames) for j in range(n_frames) if i != j and abs(i - j) <= r]
    return (np.asarray([p[0] for p in pairs], np.int32), np.asarray([p[1] for p in pairs], np.int32))


def sample_frame_graph(rng, poses, disps, intrinsics, n_frames, e_pad, num_edges=24, r=2,
                       device="cpu"):
    """A per-item graph: with probability 1/2 the covisibility graph of the
    ground truth's flow-distance matrix, else the radius-r temporal graph.
    Host-side numpy in and out (item 0 of the batch is used); the distance
    matrix is computed on `device`.  Returns (ii, jj, emask) padded to e_pad,
    padded edges (0, 1) with emask 0."""
    from ..data.rgbd_utils import compute_distance_matrix_flow

    if rng.random() < 0.5:
        d = compute_distance_matrix_flow(np.asarray(poses[0]), np.asarray(disps[0][:, 3::8, 3::8]),
                                         np.asarray(intrinsics[0]) / 8.0, device=device)
        ii, jj, _ = graph_to_edge_list(build_frame_graph(d, num=num_edges, r=r))
    else:
        ii, jj = temporal_graph(n_frames, r)
    n = min(len(ii), e_pad)
    ii_p = np.zeros(e_pad, np.int32)
    jj_p = np.zeros(e_pad, np.int32)
    em = np.zeros(e_pad, np.float32)
    ii_p[:n], jj_p[:n], em[:n] = ii[:n], jj[:n], 1.0
    jj_p[n:] = 1          # padded placeholders keep the reprojection well defined
    return ii_p, jj_p, em
