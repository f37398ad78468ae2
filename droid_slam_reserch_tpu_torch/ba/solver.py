"""Windowed dense bundle adjustment (mirror of the JAX package's ba/solver.py).

The solver works on a window of MW frames with local indices and a
``free_mask`` of optimisable poses; fixed poses get identity rows.  The
pose-depth Schur complement groups edges per depth frame (``schur_pairs``,
on the host) so that S = E Q E^T is one batched matrix product.  The pose
system is solved by an fp32 Cholesky with one refinement step, and a failed
factorisation gives a zero step.  Edges padded as (0, 0) self-edges with
zero weight add nothing.
"""
import numpy as np
import torch

from ..lie import se3_retr
from ..ops.cuda_ba import ba_system_blocks
from ..utils.timing import count, section


def schur_pairs(ii, num_buckets, max_deg=None):
    """Host-side: group edge indices by their depth bucket (source frame).

    Returns (bucket_edges [M, R] int32, bucket_mask [M, R] bool): row k
    lists the edges e with ii[e] == k, padded with 0s and masked.
    """
    ii = np.asarray(ii)
    buckets = [[] for _ in range(num_buckets)]
    for e, k in enumerate(ii):
        if 0 <= k < num_buckets:
            buckets[int(k)].append(e)
    deg = max((len(b) for b in buckets), default=0)
    R = int(max_deg) if max_deg is not None else max(deg, 1)
    edges = np.zeros((num_buckets, R), dtype=np.int32)
    mask = np.zeros((num_buckets, R), dtype=bool)
    for k, b in enumerate(buckets):
        n = min(len(b), R)
        edges[k, :n] = b[:n]
        mask[k, :n] = True
    return edges, mask


def _scatter_blocks(vals, pi, pj, valid, P):
    """Scatter-add [..., 6, 6] blocks into a dense [P, P, 6, 6]."""
    idx = torch.where(valid, pi * P + pj, torch.full_like(pi, P * P)).reshape(-1)
    vals = torch.where(valid[..., None, None], vals, torch.zeros_like(vals)).reshape(-1, 6, 6)
    out = vals.new_zeros(P * P + 1, 6, 6).index_add_(0, idx, vals)
    return out[: P * P].reshape(P, P, 6, 6)


def _pose_matrix(Hblocks, P):
    """[P, P, 6, 6] -> [6P, 6P]."""
    return Hblocks.permute(0, 2, 1, 3).reshape(6 * P, 6 * P)


def _mask_fixed(A, free6):
    """Identity rows/cols for fixed poses."""
    return A * free6[:, None] * free6[None, :] + torch.diag(1.0 - free6)


def _damped_solve(S, v, lm, ep):
    """Damped Cholesky solve with one refinement step; zeros on failure.

    No host sync: a failed factorisation (info != 0) or a NaN in the
    result selects the zero step on the device.
    """
    n = S.shape[0]
    Sd = S + torch.diag(ep + lm * torch.diagonal(S))
    L, info = torch.linalg.cholesky_ex(Sd)
    b = v[:, None]
    dx = torch.cholesky_solve(b, L)
    dx = dx + torch.cholesky_solve(b - Sd @ dx, L)
    dx = dx[:, 0]
    bad = (info != 0) | torch.isnan(dx).any()
    return torch.where(bad, torch.zeros_like(dx), dx)


def ba_iterations(poses, disps, intrinsics, disps_sens, target, weight, eta, ii, jj,
                  free_mask, bucket_edges, bucket_mask, iterations=2, lm=1e-4, ep=0.1,
                  motion_only=False, alpha=0.05, min_depth=0.25, *, blocks=ba_system_blocks):
    """Windowed dense BA with local frame indices.

    poses [MW, 7]; disps/disps_sens [MW, H, W]; intrinsics [4] (1/8 res);
    target/weight [N, H, W, 2]; eta [MW, H, W]; ii/jj [N] long local edge
    indices; free_mask [MW] bool; bucket_edges/bucket_mask [MW, R] from
    ``schur_pairs(ii, MW)``.  The per-edge blocks come from K1 on CUDA and
    from its plain version on the CPU.  Returns updated (poses, disps).

    ``blocks`` exists for timing only: the frontend profiler passes the
    uncounted plain ``system_blocks`` to time plain BA on the card.  Engine
    paths keep the default.
    """
    count("ba_iterations", iterations)
    with section("ba"):
        return _iterate(poses, disps, intrinsics, disps_sens, target, weight, eta, ii, jj,
                        free_mask, bucket_edges, bucket_mask, iterations, lm, ep, motion_only,
                        alpha, min_depth, blocks)


def _iterate(poses, disps, intrinsics, disps_sens, target, weight, eta, ii, jj, free_mask,
             bucket_edges, bucket_mask, iterations, lm, ep, motion_only, alpha, min_depth,
             blocks):
    MW = poses.shape[0]
    H, W = disps.shape[-2:]
    HW = H * W
    free = free_mask.to(poses.dtype)
    free6 = free.repeat_interleave(6)
    ok = torch.ones_like(ii, dtype=torch.bool)
    mw_idx = torch.arange(MW, device=ii.device, dtype=ii.dtype)

    for _ in range(iterations):
        blk = blocks(target, weight, poses, disps, intrinsics, ii, jj, min_depth=min_depth)
        Hmat = (_scatter_blocks(blk["Hii"], ii, ii, ok, MW)
                + _scatter_blocks(blk["Hij"], ii, jj, ok, MW)
                + _scatter_blocks(blk["Hji"], jj, ii, ok, MW)
                + _scatter_blocks(blk["Hjj"], jj, jj, ok, MW))
        v = poses.new_zeros(MW, 6).index_add_(0, ii, blk["vi"]).index_add_(0, jj, blk["vj"])
        v = v * free[:, None]
        A_pose = _mask_fixed(_pose_matrix(Hmat, MW), free6)
        v_flat = v.reshape(6 * MW)

        if motion_only:
            dx = _damped_solve(A_pose, v_flat, lm, ep).reshape(MW, 6)
        else:
            # depth diagonal + rhs with the RGB-D prior (alpha = 0.05)
            C = disps.new_zeros(MW, HW).index_add_(0, ii, blk["Ck"])
            w = disps.new_zeros(MW, HW).index_add_(0, ii, blk["wk"])
            dsens = disps_sens.reshape(MW, HW)
            m = (dsens > 0).to(C.dtype)
            C = C + m * alpha + (1.0 - m) * eta.reshape(MW, HW)
            w = w - m * alpha * (disps.reshape(MW, HW) - dsens)
            Q = 1.0 / C

            # E rows grouped per depth bucket: anchor row (sum of Ei) + edges' Ej
            A_rows = disps.new_zeros(MW, 6, HW).index_add_(0, ii, blk["Ei"])
            Gedges = blk["Ej"][bucket_edges] * bucket_mask[..., None, None]
            G = torch.cat([A_rows[:, None], Gedges], dim=1)            # [MW, R+1, 6, HW]
            pose_idx = torch.cat([mw_idx[:, None], jj[bucket_edges]], dim=1)
            row_ok = (torch.cat([torch.ones_like(bucket_mask[:, :1]), bucket_mask], dim=1)
                      & free_mask[pose_idx])
            R1 = G.shape[1]

            GQ = G * Q[:, None, None, :]
            Sk = torch.bmm(GQ.reshape(MW, R1 * 6, HW), G.reshape(MW, R1 * 6, HW).transpose(1, 2))
            Sk = Sk.reshape(MW, R1, 6, R1, 6).permute(0, 1, 3, 2, 4)  # [MW, R1, R1, 6, 6]
            pair_ok = row_ok[:, :, None] & row_ok[:, None, :]
            S = _scatter_blocks(Sk, pose_idx[:, :, None].expand(-1, -1, R1),
                                pose_idx[:, None, :].expand(-1, R1, -1), pair_ok, MW)

            # rhs reduction: v' = v - E Q w
            Ew = torch.bmm(GQ.reshape(MW, R1 * 6, HW), w[:, :, None]).reshape(MW, R1, 6)
            Ew = torch.where(row_ok[..., None], Ew, torch.zeros_like(Ew))
            vE = poses.new_zeros(MW + 1, 6).index_add_(
                0, torch.where(row_ok, pose_idx, torch.full_like(pose_idx, MW)).reshape(-1),
                Ew.reshape(-1, 6))[:MW]

            S_pose = A_pose - _pose_matrix(S, MW)
            rhs = v_flat - (vE * free[:, None]).reshape(6 * MW)
            dx = _damped_solve(S_pose, rhs, lm, ep).reshape(MW, 6) * free[:, None]

            # back-substitute depths: dz = Q (w - E^T dx)
            dx_rows = torch.where(row_ok[..., None], dx[pose_idx], torch.zeros_like(dx[pose_idx]))
            Etdx = torch.bmm(dx_rows.reshape(MW, 1, R1 * 6), G.reshape(MW, R1 * 6, HW))[:, 0]
            disps = disps + (Q * (w - Etdx)).reshape(MW, H, W)

        poses = se3_retr(poses, dx * free[:, None])
    return poses, disps
