"""Pinhole projective geometry with analytic Jacobians, plain PyTorch.

A frozen copy of the SE3 paths of the port's ``geom/projective.py``: the
pixel grid is (x, y); homogeneous points are [X, Y, 1, d] with d the
inverse depth; a stereo self-edge (ii == jj) maps through the fixed
baseline [-0.1, 0, 0, identity].
"""
import numpy as np
import torch

from .lie import se3_act, se3_adjT, se3_inv, se3_mul

MIN_DEPTH = 0.2


def coords_grid(ht, wd, device=None):
    y, x = torch.meshgrid(torch.arange(ht, dtype=torch.float32, device=device),
                          torch.arange(wd, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([x, y], dim=-1)


def _intrinsics(intrinsics):
    return intrinsics[..., None, None, :].unbind(-1)


def iproj(disps, intrinsics):
    ht, wd = disps.shape[-2:]
    fx, fy, cx, cy = _intrinsics(intrinsics)
    grid = coords_grid(ht, wd, device=disps.device)
    i = torch.ones_like(disps)
    pts = torch.stack([(grid[..., 0] - cx) / fx * i, (grid[..., 1] - cy) / fy * i, i, disps], -1)
    J = torch.zeros_like(pts)
    J[..., -1].fill_(1.0)
    return pts, J


def proj(Xs, intrinsics, min_depth):
    fx, fy, cx, cy = _intrinsics(intrinsics)
    X, Y, Z, _ = Xs.unbind(-1)
    Z = torch.where(Z < 0.5 * min_depth, torch.ones_like(Z), Z)
    d = 1.0 / Z
    coords = torch.stack([fx * (X * d) + cx, fy * (Y * d) + cy], dim=-1)
    o = torch.zeros_like(d)
    J = torch.stack([fx * d, o, -fx * X * d * d, o,
                     o, fy * d, -fy * Y * d * d, o], dim=-1).reshape(d.shape + (2, 4))
    return coords, J


def actp(Gij, X0):
    X1 = se3_act(Gij[..., None, None, :], X0)
    X, Y, Z, d = X1.unbind(-1)
    o = torch.zeros_like(d)
    Ja = torch.stack([d, o, o, o, Z, -Y,
                      o, d, o, -Z, o, X,
                      o, o, d, Y, -X, o,
                      o, o, o, o, o, o], dim=-1).reshape(d.shape + (4, 6))
    return X1, Ja


def relative_poses(poses, ii, jj):
    """poses[jj] * poses[ii]^-1, [B, N, 7], with the stereo self-edge baseline."""
    Gij = se3_mul(poses[:, jj], se3_inv(poses[:, ii]))
    fixed = Gij.new_zeros(7)
    fixed[0:1].fill_(-0.1)
    fixed[6:].fill_(1.0)
    return torch.where((ii == jj)[None, :, None], fixed, Gij)


def projective_transform(poses, depths, intrinsics, ii, jj, jacobian=False,
                         min_depth=MIN_DEPTH):
    """Pixels of frames ii mapped into frames jj: poses [B, P, 7], depths
    [B, P, H, W], intrinsics [B, P, 4] -> coords [B, N, H, W, 2], valid, and
    with ``jacobian`` (Ji, Jj, Jz)."""
    X0, Jz = iproj(depths[:, ii], intrinsics[:, ii])
    Gij = relative_poses(poses, ii, jj)
    X1, Ja = actp(Gij, X0)
    x1, Jp = proj(X1, intrinsics[:, jj], min_depth)
    valid = ((X1[..., 2] > min_depth) & (X0[..., 2] > min_depth)).to(x1.dtype)[..., None]
    if not jacobian:
        return x1, valid
    Jj = torch.matmul(Jp, Ja)
    Ji = -se3_adjT(Gij[..., None, None, None, :], Jj)
    Jz_out = torch.matmul(Jp, se3_act(Gij[..., None, None, :], Jz)[..., None])
    return x1, valid, (Ji, Jj, Jz_out)


def frame_distance(poses, disps, intrinsics, ii, jj, beta=0.3, min_depth=0.25):
    """Mean induced-flow magnitude between frame pairs, blending full and
    translation-only flow by beta; 1000 where under 75% of pixels land in
    front of the camera.  poses [P, 7], disps [P, H, W], intrinsics [4]."""
    ht, wd = disps.shape[-2:]
    fx, fy, cx, cy = intrinsics.unbind(-1)
    grid = coords_grid(ht, wd, device=disps.device)
    x, y = grid[..., 0], grid[..., 1]
    Gij = se3_mul(poses[jj], se3_inv(poses[ii]))
    d_i = disps[ii]
    X = ((x - cx) / fx).expand_as(d_i)
    Y = ((y - cy) / fy).expand_as(d_i)
    Xi = torch.stack([X, Y, torch.ones_like(d_i), d_i], dim=-1)

    def flow_mag(Xj):
        zj = Xj[..., 2]
        safe_z = torch.where(zj == 0, torch.ones_like(zj), zj)
        du = fx * (Xj[..., 0] / safe_z) + cx - x
        dv = fy * (Xj[..., 1] / safe_z) + cy - y
        return torch.sqrt(du * du + dv * dv), (zj > min_depth).to(disps.dtype)

    mag_f, ok_f = flow_mag(se3_act(Gij[:, None, None, :], Xi))
    t = Gij[:, None, None, :3]
    mag_t, ok_t = flow_mag(torch.cat([Xi[..., :3] + d_i[..., None] * t, Xi[..., 3:]], dim=-1))
    npix = ht * wd
    total = beta * npix + (1.0 - beta) * npix
    valid = beta * ok_f.sum((-2, -1)) + (1.0 - beta) * ok_t.sum((-2, -1))
    accum = beta * (mag_f * ok_f).sum((-2, -1)) + (1.0 - beta) * (mag_t * ok_t).sum((-2, -1))
    frac = valid / (total + 1e-8)
    return torch.where(frac < 0.75, torch.full_like(accum, 1000.0),
                       accum / valid.clamp_min(1e-8))


def neighbourhood_graph(n, r, c=0):
    """All ordered pairs with c < |i - j| <= r."""
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    d = np.abs(ii - jj)
    keep = (d > c) & (d <= r)
    return ii[keep], jj[keep]
