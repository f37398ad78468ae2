"""Absolute trajectory error with Umeyama alignment (copy of the JAX
package's eval/metrics.py ATE helpers, numpy only)."""
import numpy as np


def umeyama_alignment(x, y, with_scale=False):
    """Least-squares similarity (s, R, t) with y ~ s R x + t; x, y [N, 3]."""
    x = np.asarray(x, np.float64).T
    y = np.asarray(y, np.float64).T
    n = x.shape[1]
    mx = x.mean(axis=1, keepdims=True)
    my = y.mean(axis=1, keepdims=True)
    xc, yc = x - mx, y - my
    sigma_x = (xc ** 2).sum() / n
    U, d, Vt = np.linalg.svd(yc @ xc.T / n)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(d) @ S) / sigma_x) if with_scale else 1.0
    t = my - s * R @ mx
    return s, R, t.reshape(3)


def ate_rmse(est_xyz, gt_xyz, align=True, correct_scale=False):
    """RMSE of the translation error after alignment; returns (rmse, aligned est)."""
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    if align:
        s, R, t = umeyama_alignment(est, gt, with_scale=correct_scale)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2))), est
