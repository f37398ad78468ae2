"""Windowed dense bundle adjustment over poses and inverse depths, plain
PyTorch in fp32: per-edge Gauss-Newton blocks, the pose-depth Schur
complement and a damped Cholesky solve.

A frozen copy of the port's ``ba/system.py`` and ``ba/solver.py``
(weights scaled by 0.001, pixels behind ``min_depth`` weigh 0, stereo
self-edges add only depth terms, an RGB-D sensor disparity adds a prior of
weight ``alpha``), with the Schur bucket tables of its graph library in
numpy.
"""
import numpy as np
import torch

from .geom import projective_transform
from .lie import se3_retr

W_SCALE = 0.001


def system_blocks(target, weight, poses, disps, intrinsics, ii, jj, min_depth):
    """target/weight [N, H, W, 2], poses [MW, 7], disps [MW, H, W],
    intrinsics [4] -> the per-edge blocks of the normal equations."""
    N, H, W, _ = target.shape
    intr = intrinsics.expand(poses.shape[0], 4)
    coords, valid, (Ji, Jj, Jz) = projective_transform(
        poses[None], disps[None], intr[None], ii, jj, jacobian=True, min_depth=min_depth)
    Ji, Jj, Jz, coords, valid = Ji[0], Jj[0], Jz[0][..., 0], coords[0], valid[0]
    r = target - coords
    w = W_SCALE * valid * weight
    wp = w * (ii != jj).to(w.dtype)[:, None, None, None]

    def hblock(Ja, Jb):
        return torch.einsum("nhwcx,nhwc,nhwcy->nxy", Ja, wp, Jb)

    def eblock(J):
        return torch.einsum("nhwcx,nhwc,nhwc->nxhw", J, wp, Jz).reshape(N, 6, H * W)

    Hij = hblock(Ji, Jj)
    return {"Hii": hblock(Ji, Ji), "Hij": Hij, "Hji": Hij.transpose(-1, -2),
            "Hjj": hblock(Jj, Jj),
            "vi": torch.einsum("nhwcx,nhwc,nhwc->nx", Ji, wp, r),
            "vj": torch.einsum("nhwcx,nhwc,nhwc->nx", Jj, wp, r),
            "Ei": eblock(Ji), "Ej": eblock(Jj),
            "Ck": (w * Jz * Jz).sum(-1).reshape(N, H * W),
            "wk": (w * r * Jz).sum(-1).reshape(N, H * W)}


def bucket_tables(ii, num_buckets, round_to=4):
    """Edges grouped by source frame: (edges [M, R], mask [M, R]) with the
    largest degree rounded up as the program's tables round it."""
    ii = np.asarray(ii)
    valid = ii[(ii >= 0) & (ii < num_buckets)]
    deg = int(np.bincount(valid, minlength=num_buckets).max()) if len(valid) else 1
    R = ((max(deg, 1) + 1 + round_to - 1) // round_to) * round_to - 1
    edges = np.zeros((num_buckets, R), np.int64)
    mask = np.zeros((num_buckets, R), bool)
    fill = np.zeros(num_buckets, np.int64)
    for e, k in enumerate(ii.tolist()):
        if 0 <= k < num_buckets and fill[k] < R:
            edges[k, fill[k]] = e
            mask[k, fill[k]] = True
            fill[k] += 1
    return edges, mask


def _scatter_blocks(vals, pi, pj, valid, P):
    idx = torch.where(valid, pi * P + pj, torch.full_like(pi, P * P)).reshape(-1)
    vals = torch.where(valid[..., None, None], vals, torch.zeros_like(vals)).reshape(-1, 6, 6)
    return vals.new_zeros(P * P + 1, 6, 6).index_add_(0, idx, vals)[:P * P].reshape(P, P, 6, 6)


def _pose_matrix(Hblocks, P):
    return Hblocks.permute(0, 2, 1, 3).reshape(6 * P, 6 * P)


def _damped_solve(S, v, lm, ep):
    Sd = S + torch.diag(ep + lm * torch.diagonal(S))
    L, info = torch.linalg.cholesky_ex(Sd)
    b = v[:, None]
    dx = torch.cholesky_solve(b, L)
    dx = (dx + torch.cholesky_solve(b - Sd @ dx, L))[:, 0]
    bad = (info != 0) | torch.isnan(dx).any()
    return torch.where(bad, torch.zeros_like(dx), dx)


def ba_iterations(poses, disps, intrinsics, disps_sens, target, weight, eta, ii, jj, free_mask,
                  bucket_edges, bucket_mask, iterations, lm, ep, motion_only=False, alpha=0.05,
                  min_depth=0.25):
    """Dense BA over a window of MW frames with local edge indices; fixed
    frames get identity rows.  Returns the updated (poses, disps)."""
    MW = poses.shape[0]
    H, W = disps.shape[-2:]
    HW = H * W
    free = free_mask.to(poses.dtype)
    free6 = free.repeat_interleave(6)
    ok = torch.ones_like(ii, dtype=torch.bool)
    mw_idx = torch.arange(MW, device=ii.device, dtype=ii.dtype)

    for _ in range(iterations):
        blk = system_blocks(target, weight, poses, disps, intrinsics, ii, jj, min_depth)
        Hmat = (_scatter_blocks(blk["Hii"], ii, ii, ok, MW)
                + _scatter_blocks(blk["Hij"], ii, jj, ok, MW)
                + _scatter_blocks(blk["Hji"], jj, ii, ok, MW)
                + _scatter_blocks(blk["Hjj"], jj, jj, ok, MW))
        v = poses.new_zeros(MW, 6).index_add_(0, ii, blk["vi"]).index_add_(0, jj, blk["vj"])
        v = v * free[:, None]
        A = _pose_matrix(Hmat, MW)
        A = A * free6[:, None] * free6[None, :] + torch.diag(1.0 - free6)
        v_flat = v.reshape(6 * MW)

        if motion_only:
            dx = _damped_solve(A, v_flat, lm, ep).reshape(MW, 6)
        else:
            C = disps.new_zeros(MW, HW).index_add_(0, ii, blk["Ck"])
            w = disps.new_zeros(MW, HW).index_add_(0, ii, blk["wk"])
            dsens = disps_sens.reshape(MW, HW)
            m = (dsens > 0).to(C.dtype)
            C = C + m * alpha + (1.0 - m) * eta.reshape(MW, HW)
            w = w - m * alpha * (disps.reshape(MW, HW) - dsens)
            Q = 1.0 / C

            A_rows = disps.new_zeros(MW, 6, HW).index_add_(0, ii, blk["Ei"])
            G = torch.cat([A_rows[:, None], blk["Ej"][bucket_edges]
                           * bucket_mask[..., None, None]], dim=1)          # [MW, R+1, 6, HW]
            pose_idx = torch.cat([mw_idx[:, None], jj[bucket_edges]], dim=1)
            row_ok = (torch.cat([torch.ones_like(bucket_mask[:, :1]), bucket_mask], dim=1)
                      & free_mask[pose_idx])
            R1 = G.shape[1]
            GQ = G * Q[:, None, None, :]
            Sk = torch.bmm(GQ.reshape(MW, R1 * 6, HW), G.reshape(MW, R1 * 6, HW).transpose(1, 2))
            Sk = Sk.reshape(MW, R1, 6, R1, 6).permute(0, 1, 3, 2, 4)
            S = _scatter_blocks(Sk, pose_idx[:, :, None].expand(-1, -1, R1),
                                pose_idx[:, None, :].expand(-1, R1, -1),
                                row_ok[:, :, None] & row_ok[:, None, :], MW)
            Ew = torch.bmm(GQ.reshape(MW, R1 * 6, HW), w[:, :, None]).reshape(MW, R1, 6)
            Ew = torch.where(row_ok[..., None], Ew, torch.zeros_like(Ew))
            vE = poses.new_zeros(MW + 1, 6).index_add_(
                0, torch.where(row_ok, pose_idx, torch.full_like(pose_idx, MW)).reshape(-1),
                Ew.reshape(-1, 6))[:MW]
            rhs = v_flat - (vE * free[:, None]).reshape(6 * MW)
            dx = _damped_solve(A - _pose_matrix(S, MW), rhs, lm, ep).reshape(MW, 6)
            dx = dx * free[:, None]
            dx_rows = torch.where(row_ok[..., None], dx[pose_idx], torch.zeros_like(dx[pose_idx]))
            Etdx = torch.bmm(dx_rows.reshape(MW, 1, R1 * 6), G.reshape(MW, R1 * 6, HW))[:, 0]
            disps = disps + (Q * (w - Etdx)).reshape(MW, H, W)

        poses = se3_retr(poses, dx * free[:, None])
    return poses, disps
