"""SE3 map-to-map alignment (mirror of multisession/alignment.py; reference
loop_detect.py:256-335,411-423).  numpy in and out; the SE3 products run in
the port's lie/ on fp32 CPU tensors: a few hundred 7-vectors on the host."""
import numpy as np
import torch

from ..lie import se3_inv, se3_mul


def _se3(x):
    return torch.from_numpy(np.array(x, np.float32))


def compute_filtered_mean(rows):
    """Per-column mean after IQR outlier removal (reference :256-282).

    rows: [N, D] numpy array.  Returns [D].
    """
    rows = np.asarray(rows, np.float64)
    out = np.empty(rows.shape[1])
    for i in range(rows.shape[1]):
        col = rows[:, i]
        q1, q3 = np.quantile(col, 0.25), np.quantile(col, 0.75)
        iqr = q3 - q1
        keep = (col >= q1 - 1.5 * iqr) & (col <= q3 + 1.5 * iqr)
        out[i] = col[keep].mean() if keep.any() else col.mean()
    return out


def normalize_transform(T):
    """Renormalize the quaternion part of a 7-vector (reference
    AdjustCoordinates.py:174-178)."""
    T = np.asarray(T, np.float64).copy()
    q = T[3:7]
    T[3:7] = q / np.linalg.norm(q)
    return T


def estimate_alignment(old_poses, loop_poses):
    """Per-correspondence transforms T_k = P_old[k] * P_loop[k]^-1
    (reference AdjustCoordinates.py:165-167), IQR-filtered mean, quaternion
    renormalized.  Returns (T [7] float32, rows [N, 7])."""
    rows = se3_mul(_se3(old_poses), se3_inv(_se3(loop_poses))).numpy()
    T = normalize_transform(compute_filtered_mean(rows))
    return T.astype(np.float32), rows


def transform_poses(T, poses, inverse=True):
    """Apply T to every pose: T^-1 * P (default, reference
    loop_detect.py:311-322 getTransformedPoses) or T * P (:324-335)."""
    T, P = _se3(T), _se3(poses)
    return se3_mul((se3_inv(T) if inverse else T)[None], P).numpy()


def remove_outlier_rows(rows, thresh=2.0):
    """Drop rows whose translation deviates > thresh stds from the median
    (reference loop_detect.py:411-423 outlier row removal)."""
    rows = np.asarray(rows)
    t = rows[:, :3]
    med = np.median(t, axis=0)
    d = np.linalg.norm(t - med, axis=1)
    std = d.std() + 1e-8
    return rows[d < thresh * std] if (d < thresh * std).any() else rows
