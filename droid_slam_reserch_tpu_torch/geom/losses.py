"""Training losses on tensors (mirror of the JAX package's geom/losses.py):

- geodesic_loss: gamma-weighted relative-pose loss over the graph's edges;
- residual_loss: gamma-weighted mean |BA residual|;
- flow_loss: gamma-weighted end-point error on the +-1 temporal edges.

Metrics are computed from detached tensors: they are read, not differentiated.
"""
import numpy as np
import torch

from ..lie import se3_inv, se3_log, se3_mul, sim3_inv, sim3_log, sim3_mul, so3_log
from .projective import projective_transform


def _safe_norm(x, dim=-1):
    """L2 norm with a finite gradient at exactly zero (the gradient of
    ``torch.linalg.norm`` at 0 is NaN, and one such pixel, even masked out,
    poisons every parameter through the global-norm clip)."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + 1e-12)


def _rel(poses, ii, jj, group):
    if group == "se3":
        return se3_mul(poses[:, jj], se3_inv(poses[:, ii]))
    return sim3_mul(poses[:, jj], sim3_inv(poses[:, ii]))


def fit_scale(Ps, Gs):
    """Least-squares scale aligning the translations of Gs to Ps."""
    b = Ps.shape[0]
    t1 = Ps[..., :3].reshape(b, -1)
    t2 = Gs[..., :3].reshape(b, -1)
    return torch.sum(t1 * t2, -1) / (torch.sum(t2 * t2, -1) + 1e-8)


def pose_metrics(dG, dP):
    """Rotation (degrees), translation and scale errors of dG against dP."""
    if dG.shape[-1] == 7:
        dE = se3_mul(dG, se3_inv(dP))
        s_err = torch.zeros_like(dE[..., 0])
    else:
        dE = sim3_mul(dG, sim3_inv(dP))
        s_err = (dE[..., 7] - 1.0).abs()
    r_err = (180.0 / np.pi) * torch.linalg.norm(so3_log(dE[..., 3:7]), dim=-1)
    t_err = torch.linalg.norm(dE[..., :3], dim=-1)
    return r_err, t_err, s_err


def _masked_mean(x, mask):
    """Mean of x [B, E] counting only the mask's valid [E] edges."""
    if mask is None:
        return x.mean()
    m = mask.to(x.dtype)
    return torch.sum(x * m[None, :]) / torch.clamp_min(x.shape[0] * m.sum(), 1.0)


def geodesic_loss(Ps, Gs_list, ii, jj, gamma=0.9, do_scale=True, group="se3", edge_mask=None):
    """Ps: ground-truth poses [B, P, 7|8]; Gs_list: the estimate of every
    iteration.  edge_mask: optional [E] validity of a padded sampled graph;
    masked edges add to neither the loss nor the metrics."""
    dP = _rel(Ps, ii, jj, group)
    n = len(Gs_list)
    loss = 0.0
    for i, Gs in enumerate(Gs_list):
        w = gamma ** (n - i - 1)
        dG = _rel(Gs, ii, jj, group)
        if do_scale:
            s = fit_scale(dP, dG)
            dG = torch.cat([dG[..., :3] * s[:, None, None], dG[..., 3:]], dim=-1)
        if group == "se3":
            d = se3_log(se3_mul(dG, se3_inv(dP)))
            loss = loss + w * (_masked_mean(_safe_norm(d[..., :3]), edge_mask)
                               + _masked_mean(_safe_norm(d[..., 3:6]), edge_mask))
        else:
            d = sim3_log(sim3_mul(dG, sim3_inv(dP)))
            loss = loss + w * (_masked_mean(_safe_norm(d[..., :3]), edge_mask)
                               + _masked_mean(_safe_norm(d[..., 3:6]), edge_mask)
                               + 0.05 * _masked_mean(_safe_norm(d[..., 6:7]), edge_mask))

    with torch.no_grad():
        r_err, t_err, _ = pose_metrics(dG, dP)
        metrics = {
            "rot_error": _masked_mean(r_err, edge_mask),
            "tr_error": _masked_mean(t_err, edge_mask),
            "bad_rot": _masked_mean((r_err < 0.1).float(), edge_mask),
            "bad_tr": _masked_mean((t_err < 0.01).float(), edge_mask),
        }
    return loss, metrics


def residual_loss(residuals, gamma=0.9, edge_mask=None):
    """residuals: the [B, E, h, w, 2] residual of every iteration."""
    n = len(residuals)
    loss = 0.0
    for i, r in enumerate(residuals):
        w = gamma ** (n - i - 1)
        r_edge = r.abs().mean(dim=tuple(range(2, r.ndim)))
        loss = loss + w * _masked_mean(r_edge, edge_mask)
    return loss, {"residual": loss.detach()}


def flow_loss(Ps, disps, poses_est, disps_est, intrinsics, gamma=0.9):
    """End-point error between the ground truth's induced flow and the
    estimates', on the edges |i - j| = 1 at full resolution."""
    N = Ps.shape[1]
    pairs = [(i, j) for i in range(N) for j in range(N) if abs(i - j) == 1]
    ii = torch.tensor([p[0] for p in pairs], dtype=torch.long, device=Ps.device)
    jj = torch.tensor([p[1] for p in pairs], dtype=torch.long, device=Ps.device)

    coords0, val0 = projective_transform(Ps, disps, intrinsics, ii, jj)
    val0 = val0 * (disps[:, ii] > 0).to(val0.dtype)[..., None]

    n = len(poses_est)
    loss = 0.0
    for i in range(n):
        w = gamma ** (n - i - 1)
        coords1, val1 = projective_transform(poses_est[i], disps_est[i], intrinsics, ii, jj)
        v = (val0 * val1)[..., 0]
        epe = v * _safe_norm(coords1 - coords0)
        loss = loss + w * epe.mean()

    with torch.no_grad():
        mask = v.reshape(-1) > 0.5
        epe_flat = epe.reshape(-1)
        denom = torch.clamp_min(mask.sum(), 1)
        zero = torch.zeros_like(epe_flat)
        metrics = {
            "f_error": torch.where(mask, epe_flat, zero).sum() / denom,
            "1px": torch.where(mask, (epe_flat < 1.0).float(), zero).sum() / denom,
        }
    return loss, metrics
