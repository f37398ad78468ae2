"""TUM-format listing and pairwise distance matrices (mirror of the JAX
package's data/rgbd_utils.py; reference data_readers/rgbd_utils.py)."""
import os.path as osp

import numpy as np
import torch

from ..geom.projective import induced_flow
from ..lie import se3_inv, se3_log, se3_mul


def parse_list(filepath, skiprows=0):
    return np.loadtxt(filepath, delimiter=" ", dtype=np.str_, skiprows=skiprows)


def associate_frames(tstamp_image, tstamp_depth, tstamp_pose, max_dt=1.0):
    """Pair images, depths and poses by timestamp."""
    associations = []
    for i, t in enumerate(tstamp_image):
        j = np.argmin(np.abs(tstamp_depth - t))
        if tstamp_pose is None:
            if np.abs(tstamp_depth[j] - t) < max_dt:
                associations.append((i, j))
        else:
            k = np.argmin(np.abs(tstamp_pose - t))
            if np.abs(tstamp_depth[j] - t) < max_dt and np.abs(tstamp_pose[k] - t) < max_dt:
                associations.append((i, j, k))
    return associations


def loadtum(datapath, frame_rate=-1):
    """Image and depth paths, poses, intrinsics and timestamps of a
    TUM-RGBD-format sequence (every 5th association)."""
    if osp.isfile(osp.join(datapath, "groundtruth.txt")):
        pose_list = osp.join(datapath, "groundtruth.txt")
    elif osp.isfile(osp.join(datapath, "pose.txt")):
        pose_list = osp.join(datapath, "pose.txt")
    else:
        return None, None, None, None, None

    image_data = parse_list(osp.join(datapath, "rgb.txt"))
    depth_data = parse_list(osp.join(datapath, "depth.txt"))
    pose_data = parse_list(pose_list, skiprows=1)
    pose_vecs = pose_data[:, 1:].astype(np.float64)

    calib_path = osp.join(datapath, "calibration.txt")
    intrinsic = np.loadtxt(calib_path, delimiter=" ") if osp.isfile(calib_path) else None

    tstamp_image = image_data[:, 0].astype(np.float64)
    tstamp_depth = depth_data[:, 0].astype(np.float64)
    tstamp_pose = pose_data[:, 0].astype(np.float64)
    associations = associate_frames(tstamp_image, tstamp_depth, tstamp_pose)

    images, poses, depths, intrinsics, tstamps = [], [], [], [], []
    for ix in range(len(associations))[::5]:
        (i, j, k) = associations[ix]
        images.append(osp.join(datapath, image_data[i, 1]))
        depths.append(osp.join(datapath, depth_data[j, 1]))
        poses.append(pose_vecs[k])
        tstamps.append(tstamp_image[i])
        if intrinsic is not None:
            intrinsics.append(intrinsic)
    return images, depths, poses, intrinsics, tstamps


def all_pairs_distance_matrix(poses, beta=2.5, device="cpu"):
    """Pose-space distance matrix: |log(P_i^-1 P_j)| with translations scaled by beta."""
    poses = np.array(poses, dtype=np.float32)
    poses[:, :3] *= beta
    P = torch.from_numpy(poses).to(device)
    rel = se3_mul(se3_inv(P[:, None]), P[None, :])
    return torch.linalg.norm(se3_log(rel), dim=-1).cpu().numpy()


def compute_distance_matrix_flow(poses, disps, intrinsics, chunk=2048, device="cpu"):
    """Bidirectional mean-flow distance matrix [N, N], on `device`.

    poses [N, 7] (world-to-camera, TUM [t, q] order), disps [N, h, w]
    subsampled, intrinsics [N, 4] at the disparities' resolution.  A pair
    where fewer than 70% of the pixels land in front of the camera is inf.
    """
    N = len(poses)
    poses = se3_inv(torch.as_tensor(np.asarray(poses, np.float32), device=device))
    disps = torch.as_tensor(np.asarray(disps, np.float32), device=device)
    intrinsics = torch.as_tensor(np.asarray(intrinsics, np.float32), device=device)

    ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    ii = torch.as_tensor(ii.reshape(-1), device=device)
    jj = torch.as_tensor(jj.reshape(-1), device=device)

    MAX_FLOW = 100.0
    out = []
    for s in range(0, len(ii), chunk):
        ci, cj = ii[s: s + chunk], jj[s: s + chunk]
        flow1, val1 = induced_flow(poses[None], disps[None], intrinsics[None], ci, cj)
        flow2, val2 = induced_flow(poses[None], disps[None], intrinsics[None], cj, ci)
        mag1 = torch.linalg.norm(flow1[0], dim=-1).clamp_max(MAX_FLOW)
        mag2 = torch.linalg.norm(flow2[0], dim=-1).clamp_max(MAX_FLOW)
        n = len(ci)
        mag = torch.cat([mag1.reshape(n, -1), mag2.reshape(n, -1)], -1)
        val = torch.cat([val1[0, ..., 0].reshape(n, -1), val2[0, ..., 0].reshape(n, -1)], -1)
        flo = (mag * val).sum(-1) / val.sum(-1).clamp_min(1e-8)
        out.append(torch.where(val.mean(-1) < 0.7, torch.full_like(flo, float("inf")), flo))
    return torch.cat(out).cpu().numpy().reshape(N, N)
