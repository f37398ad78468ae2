"""Point clouds from SLAM state (mirror of viz/pointcloud.py): plain torch
on the tensors' device, and a host PLY writer.

- backproject_points: the iproj kernel's function (reference
  droid_kernels.cu:779-850, used by visualization.py:106)
- depth_filter: the multi-view depth-consistency count (reference
  droid_kernels.cu:661-775, used by visualization.py:110-115)
- export_ply / reconstruction_pointcloud: the offline dump (vis_*.py)
"""
import numpy as np
import torch

from ..lie import se3_act, se3_inv, se3_mul


def _pixel_grid(H, W, device):
    y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    return y, x


def backproject_points(poses, disps, intrinsics):
    """Every pixel as a world-frame 3D point.

    poses [P, 7] world-to-camera; disps [P, H, W]; intrinsics [4] at the
    disparities' resolution.  Returns points [P, H, W, 3].
    """
    _, H, W = disps.shape
    fx, fy, cx, cy = intrinsics
    y, x = _pixel_grid(H, W, disps.device)
    d = disps.clamp_min(1e-6)
    X = torch.stack([((x - cx) / fx).expand_as(d) / d, ((y - cy) / fy).expand_as(d) / d,
                     1.0 / d, torch.ones_like(d)], dim=-1)
    return se3_act(se3_inv(poses)[:, None, None, :], X)[..., :3]


def depth_filter(poses, disps, intrinsics, ix, thresh):
    """Count the neighbours that agree with each pixel's depth (reference
    droid_kernels.cu:661-775): keyframe ix's pixels are projected into the 6
    neighbours {ix-1, ix-2, ix-3, ix+3, ix+4, ix+5}; a neighbour agrees if
    one of the 4 integer corners at the landing point has
    |1/d_proj - 1/d_corner| < thresh.

    poses [P, 7], disps [P, H, W], intrinsics [4], ix [K] frame indices,
    thresh [K].  Returns counts [K, H, W] (fp32).
    """
    P, H, W = disps.shape
    dev = disps.device
    fx, fy, cx, cy = intrinsics
    y, x = _pixel_grid(H, W, dev)
    ix = torch.as_tensor(np.asarray(ix, np.int64), device=dev)
    thresh = torch.as_tensor(np.asarray(thresh, np.float32), device=dev)[:, None, None]
    K = len(ix)

    di = disps[ix]
    Xi = torch.stack([((x - cx) / fx).expand_as(di), ((y - cy) / fy).expand_as(di),
                      torch.ones_like(di), di], dim=-1)
    counts = torch.zeros(K, H, W, device=dev)
    for neigh in (-1, -2, -3, 3, 4, 5):
        jx = ix + neigh
        ok_frame = (jx >= 0) & (jx < P)
        jxc = jx.clamp(0, P - 1)
        Gij = se3_mul(poses[jxc], se3_inv(poses[ix]))
        Xj = se3_act(Gij[:, None, None, :], Xi)
        zj = torch.where(Xj[..., 2] == 0, 1.0, Xj[..., 2])
        uj = fx * Xj[..., 0] / zj + cx
        vj = fy * Xj[..., 1] / zj + cy
        dj = Xj[..., 3] / zj

        u0 = torch.floor(uj).long()
        v0 = torch.floor(vj).long()
        inb = (u0 >= 0) & (v0 >= 0) & (u0 < W - 1) & (v0 < H - 1)
        u0c = u0.clamp(0, W - 2)
        v0c = v0.clamp(0, H - 2)

        dn = disps[jxc].reshape(K, H * W)
        agree = torch.zeros(di.shape, dtype=torch.bool, device=dev)
        for dv in (0, 1):
            for du in (0, 1):
                idx = (v0c + dv) * W + (u0c + du)
                dcorner = torch.gather(dn, 1, idx.reshape(K, -1)).reshape(di.shape)
                diff = (1.0 / dj.clamp_min(1e-6) - 1.0 / dcorner.clamp_min(1e-6)).abs()
                agree = agree | (diff < thresh)
        counts = counts + (agree & inb & ok_frame[:, None, None]).float()
    return counts


def reconstruction_pointcloud(state, filter_thresh=0.005, filter_count=2, device="cuda"):
    """Colored, filtered point cloud (numpy points [N, 3], colors [N, 3] in
    0..1) from a session state dict, computed on ``device``.

    The visualizer's masking (reference visualization.py:106-120): keep the
    points whose disparity beats half its frame's mean and agrees with at
    least filter_count neighbours, at a threshold of filter_thresh times
    the mean disparity.
    """
    dev = torch.device(device)
    poses = torch.tensor(np.asarray(state["poses"], np.float32), device=dev)
    disps = torch.tensor(np.asarray(state["disps"], np.float32), device=dev)
    intr = torch.tensor(np.asarray(state["intrinsics"][0], np.float32), device=dev)
    P = len(poses)

    pts = backproject_points(poses, disps, intr).cpu().numpy()
    thresh = filter_thresh * np.ones(P) * float(disps.mean())
    counts = depth_filter(poses, disps, intr, np.arange(P), thresh).cpu().numpy()

    disps_np = disps.cpu().numpy()
    masks = (counts >= filter_count) & (
        disps_np > 0.5 * disps_np.mean(axis=(1, 2), keepdims=True)
    )
    H8, W8 = disps_np.shape[1:]
    colors = state["images"][:, 3::8, 3::8][:, :H8, :W8, ::-1] / 255.0  # BGR -> RGB
    return pts[masks], colors[masks]


def export_ply(path, points, colors=None):
    """Write an ascii PLY point cloud (the offline vis_*.py dump)."""
    points = np.asarray(points).reshape(-1, 3)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if colors is not None:
            colors = (np.asarray(colors).reshape(-1, 3) * 255).astype(np.uint8)
            for p, c in zip(points, colors):
                f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} {c[0]} {c[1]} {c[2]}\n")
        else:
            for p in points:
                f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
