"""Differentiable dense bundle adjustment for training (mirror of the JAX
package's ba/dense.py).

One Gauss-Newton step with the depths eliminated by a dense Schur
complement; gradients flow through the Cholesky solves (ba/chol.py).  Every
one of the P frames is a depth bucket, so frames without edges get a zero
update.  Block scatters put edges whose index falls outside the matrix into
an overflow bucket that is dropped.
"""
import torch

from ..lie import se3_retr, sim3_retr
from .chol import block_solve, schur_solve
from .system import build_system_blocks


def _scatter_mat(A, ii, jj, n, m):
    """Scatter-add [B, N, ...] blocks into a dense [B, n, m, ...]."""
    v = (ii >= 0) & (jj >= 0) & (ii < n) & (jj < m)
    idx = torch.where(v, ii * m + jj, torch.full_like(ii, n * m))
    vmask = v.reshape((1, -1) + (1,) * (A.ndim - 2))
    out = A.new_zeros((A.shape[0], n * m + 1) + A.shape[2:])
    out = out.index_add(1, idx, torch.where(vmask, A, torch.zeros_like(A)))
    return out[:, : n * m].reshape(A.shape[0], n, m, *A.shape[2:])


def _scatter_vec(b, ii, n):
    v = (ii >= 0) & (ii < n)
    idx = torch.where(v, ii, torch.full_like(ii, n))
    vmask = v.reshape((1, -1) + (1,) * (b.ndim - 2))
    out = b.new_zeros((b.shape[0], n + 1) + b.shape[2:])
    out = out.index_add(1, idx, torch.where(vmask, b, torch.zeros_like(b)))
    return out[:, :n]


def _pose_system(blk, ii, jj, fixedp, P):
    """The free poses' Hessian [B, Pf, Pf, D, D] and rhs [B, Pf, D]."""
    Pf, iif, jjf = P - fixedp, ii - fixedp, jj - fixedp
    H = (_scatter_mat(blk["Hii"], iif, iif, Pf, Pf) + _scatter_mat(blk["Hij"], iif, jjf, Pf, Pf)
         + _scatter_mat(blk["Hji"], jjf, iif, Pf, Pf) + _scatter_mat(blk["Hjj"], jjf, jjf, Pf, Pf))
    v = _scatter_vec(blk["vi"], iif, Pf) + _scatter_vec(blk["vj"], jjf, Pf)
    return H, v


def _retract(poses, dx, fixedp, group):
    """Retract the free poses by dx [B, P - fixedp, D]; the first fixedp stay."""
    retr = se3_retr if group == "se3" else sim3_retr
    zero = dx.new_zeros(dx.shape[0], fixedp, dx.shape[-1])
    return retr(poses, torch.cat([zero, dx], dim=1))


def BA(target, weight, eta, poses, disps, intrinsics, ii, jj, fixedp=1, group="se3",
       min_depth=0.2, ep=0.1, lm=1e-4):
    """One differentiable BA step.  target, weight [B, N, H, W, 2]; eta
    [B, P, H, W] per-frame damping; poses [B, P, 7|8]; disps [B, P, H, W];
    ii, jj [N] long.  Returns the updated (poses, disps)."""
    B, P, H, W = disps.shape
    D = 6 if group == "se3" else 7
    blk = build_system_blocks(target, weight, poses, disps, intrinsics, ii, jj, group=group,
                              min_depth=min_depth)
    H_mat, v = _pose_system(blk, ii, jj, fixedp, P)

    # pose-depth coupling: an edge's depth bucket is its source frame ii
    Pf, iif, jjf = P - fixedp, ii - fixedp, jj - fixedp
    E = _scatter_mat(blk["Ei"], iif, ii, Pf, P) + _scatter_mat(blk["Ej"], jjf, ii, Pf, P)
    E = E.reshape(B, Pf, P, D, H * W)
    C = _scatter_vec(blk["Ck"], ii, P) + eta.reshape(B, P, H * W) + 1e-7
    w = _scatter_vec(blk["wk"], ii, P)

    dx, dz = schur_solve(H_mat, E, C, v, w, ep=ep, lm=lm)
    poses = _retract(poses, dx, fixedp, group)
    disps = disps + dz.reshape(B, P, H, W)
    disps = torch.where(disps > 10.0, torch.zeros_like(disps), disps)
    return poses, torch.maximum(disps, torch.zeros_like(disps))


def MoBA(target, weight, eta, poses, disps, intrinsics, ii, jj, fixedp=1, group="se3",
         min_depth=0.2, ep=0.1, lm=1e-4):
    """One motion-only BA step: returns the updated poses."""
    blk = build_system_blocks(target, weight, poses, disps, intrinsics, ii, jj, group=group,
                              min_depth=min_depth)
    H_mat, v = _pose_system(blk, ii, jj, fixedp, poses.shape[1])
    return _retract(poses, block_solve(H_mat, v, ep=ep, lm=lm), fixedp, group)
