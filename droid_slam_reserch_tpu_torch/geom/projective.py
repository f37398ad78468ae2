"""Pinhole projective geometry with analytic Jacobians on tensors.

Mirror of the JAX package's geom/projective.py (SE3, and Sim3 with
``group="sim3"``):
- the pixel grid is (x, y) with x = column index, y = row index;
- homogeneous points are [X, Y, 1, d] with d the inverse depth;
- stereo self-edges (ii == jj) use the fixed baseline [-0.1, 0, 0, identity];
- MIN_DEPTH = 0.2 on the projection path; the inference BA passes 0.25.
"""
import torch

from ..lie import se3_act, se3_adjT, se3_inv, se3_mul, sim3_act, sim3_adjT, sim3_inv, sim3_mul

MIN_DEPTH = 0.2
STEREO_SE3 = (-0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0)
# group -> (mul, inv, act, adjT, manifold dim)
GROUPS = {"se3": (se3_mul, se3_inv, se3_act, se3_adjT, 6),
          "sim3": (sim3_mul, sim3_inv, sim3_act, sim3_adjT, 7)}


def coords_grid(ht, wd, dtype=torch.float32, device=None):
    """Pixel grid [ht, wd, 2] of (x, y) coordinates."""
    y, x = torch.meshgrid(
        torch.arange(ht, dtype=dtype, device=device),
        torch.arange(wd, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([x, y], dim=-1)


def _intrinsics(intrinsics):
    """[..., 4] -> four [..., 1, 1] maps (fx, fy, cx, cy)."""
    return intrinsics[..., None, None, :].unbind(-1)


def iproj(disps, intrinsics, jacobian=False):
    """Inverse projection: disps [..., H, W] -> points [..., H, W, 4]."""
    ht, wd = disps.shape[-2:]
    fx, fy, cx, cy = _intrinsics(intrinsics)
    grid = coords_grid(ht, wd, dtype=disps.dtype, device=disps.device)
    i = torch.ones_like(disps)
    X = (grid[..., 0] - cx) / fx
    Y = (grid[..., 1] - cy) / fy
    pts = torch.stack([X * i, Y * i, i, disps], dim=-1)
    if jacobian:
        J = torch.zeros_like(pts)
        J[..., -1].fill_(1.0)
        return pts, J
    return pts, None


def proj(Xs, intrinsics, jacobian=False, return_depth=False, min_depth=MIN_DEPTH):
    """Pinhole projection of homogeneous points [..., 4]."""
    fx, fy, cx, cy = _intrinsics(intrinsics)
    X, Y, Z, D = Xs.unbind(-1)
    Z = torch.where(Z < 0.5 * min_depth, torch.ones_like(Z), Z)
    d = 1.0 / Z
    x = fx * (X * d) + cx
    y = fy * (Y * d) + cy
    coords = torch.stack([x, y, D * d] if return_depth else [x, y], dim=-1)
    if jacobian:
        o = torch.zeros_like(d)
        J = torch.stack(
            [fx * d, o, -fx * X * d * d, o,
             o, fy * d, -fy * Y * d * d, o],
            dim=-1,
        ).reshape(d.shape + (2, 4))
        return coords, J
    return coords, None


def actp(Gij, X0, jacobian=False, group="se3"):
    """Group action on homogeneous point clouds; Gij [..., 7|8], X0 [..., H, W, 4]."""
    X1 = GROUPS[group][2](Gij[..., None, None, :], X0)
    if not jacobian:
        return X1, None
    X, Y, Z, d = X1.unbind(-1)
    o = torch.zeros_like(d)
    if group == "se3":
        Ja = torch.stack(
            [d, o, o, o, Z, -Y,
             o, d, o, -Z, o, X,
             o, o, d, Y, -X, o,
             o, o, o, o, o, o],
            dim=-1,
        ).reshape(d.shape + (4, 6))
    else:
        Ja = torch.stack(
            [d, o, o, o, Z, -Y, X,
             o, d, o, -Z, o, X, Y,
             o, o, d, Y, -X, o, Z,
             o, o, o, o, o, o, o],
            dim=-1,
        ).reshape(d.shape + (4, 7))
    return X1, Ja


def relative_poses(poses, ii, jj, stereo=True, group="se3"):
    """Gij = poses[jj] * poses[ii]^-1 with the stereo self-edge override.

    poses: [B, P, 7|8]; ii/jj: [N] long tensors.  Returns [B, N, 7|8].
    """
    mul, inv = GROUPS[group][:2]
    Gij = mul(poses[:, jj], inv(poses[:, ii]))
    if stereo:
        # fill_ passes the value in the launch; a host tensor or an item
        # assignment would copy from the host and wait for the stream
        fixed = Gij.new_zeros(Gij.shape[-1])
        fixed[0:1].fill_(STEREO_SE3[0])
        fixed[6:].fill_(1.0)          # qw, and Sim3's scale
        Gij = torch.where((ii == jj)[None, :, None], fixed, Gij)
    return Gij


def projective_transform(poses, depths, intrinsics, ii, jj, jacobian=False,
                         return_depth=False, min_depth=MIN_DEPTH, group="se3"):
    """Map pixels of frames ii into frames jj.

    poses [B, P, 7|8], depths [B, P, H, W] (inverse depth), intrinsics
    [B, P, 4], ii/jj [N].  Returns (coords [B,N,H,W,2(+1)], valid
    [B,N,H,W,1]) and, with jacobian=True, also (Ji, Jj, Jz).
    """
    X0, Jz = iproj(depths[:, ii], intrinsics[:, ii], jacobian=jacobian)
    Gij = relative_poses(poses, ii, jj, group=group)
    X1, Ja = actp(Gij, X0, jacobian=jacobian, group=group)
    x1, Jp = proj(X1, intrinsics[:, jj], jacobian=jacobian,
                  return_depth=return_depth, min_depth=min_depth)
    valid = ((X1[..., 2] > min_depth) & (X0[..., 2] > min_depth)).to(x1.dtype)[..., None]
    if jacobian:
        _, _, act, adjT, _ = GROUPS[group]
        Jj = torch.matmul(Jp, Ja)
        Ji = -adjT(Gij[..., None, None, None, :], Jj)
        Jz_t = act(Gij[..., None, None, :], Jz)
        Jz_out = torch.matmul(Jp, Jz_t[..., None])
        return x1, valid, (Ji, Jj, Jz_out)
    return x1, valid


def projmap(poses, disps, intrinsics, ii, jj, group="se3", min_depth=MIN_DEPTH):
    """Dense reprojection coords with the depth channel, and validity, per edge."""
    return projective_transform(poses, disps, intrinsics, ii, jj, return_depth=True,
                                group=group, min_depth=min_depth)


def induced_flow(poses, disps, intrinsics, ii, jj, group="se3"):
    """Optical flow induced by camera motion, and validity."""
    ht, wd = disps.shape[-2:]
    coords0 = coords_grid(ht, wd, dtype=disps.dtype, device=disps.device)
    coords1, valid = projective_transform(poses, disps, intrinsics, ii, jj, group=group)
    return coords1[..., :2] - coords0, valid


def frame_distance(poses, disps, intrinsics, ii, jj, beta=0.3, min_depth=0.25):
    """Mean induced-flow magnitude between frame pairs.

    Blends full-SE3 flow with translation-only flow by beta; returns 1000
    where fewer than 75% of pixels land in front of the camera.
    poses [P, 7], disps [P, H, W], intrinsics [4], ii/jj [N] -> dist [N].
    """
    ht, wd = disps.shape[-2:]
    fx, fy, cx, cy = intrinsics.unbind(-1)
    grid = coords_grid(ht, wd, dtype=disps.dtype, device=disps.device)
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
    Xj_t = torch.cat([Xi[..., :3] + d_i[..., None] * t, Xi[..., 3:]], dim=-1)
    mag_t, ok_t = flow_mag(Xj_t)

    npix = ht * wd
    total = beta * npix + (1.0 - beta) * npix
    valid = beta * ok_f.sum((-2, -1)) + (1.0 - beta) * ok_t.sum((-2, -1))
    accum = (beta * (mag_f * ok_f).sum((-2, -1))
             + (1.0 - beta) * (mag_t * ok_t).sum((-2, -1)))
    frac = valid / (total + 1e-8)
    return torch.where(frac < 0.75, torch.full_like(accum, 1000.0),
                       accum / valid.clamp_min(1e-8))
