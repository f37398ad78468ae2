"""ATE / RPE / KITTI-style metrics with SE3/Sim3 Umeyama alignment (copy of
the JAX package's eval/metrics.py, numpy only).

Protocol matches the reference's evaluation flow: evo-style APE on the
translation part after SE3 Umeyama alignment with optional scale correction
(reference test_euroc.py:136-145; scale correction on for mono, off for
stereo/multisession, Whole_Evaluate.py:225), and the tartanair_tools
scale-aligned ATE (tartanair_evaluator.py:40+).
"""
import numpy as np


def tum_trajectory_to_matrix(traj):
    """TUM rows [t, tx, ty, tz, qx, qy, qz, qw] -> (stamps [N], pos [N,3], quat [N,4])."""
    traj = np.asarray(traj, np.float64)
    return traj[:, 0], traj[:, 1:4], traj[:, 4:8]


def umeyama_alignment(x, y, with_scale=False):
    """Least-squares similarity transform aligning x to y.

    x, y: [N, 3] point sets.  Returns (s, R, t) with y ~ s R x + t.
    Standard Umeyama (1991) closed form.
    """
    x = np.asarray(x, np.float64).T  # [3, N]
    y = np.asarray(y, np.float64).T
    n = x.shape[1]

    mx = x.mean(axis=1, keepdims=True)
    my = y.mean(axis=1, keepdims=True)
    xc, yc = x - mx, y - my
    sigma_x = (xc ** 2).sum() / n
    cov = yc @ xc.T / n

    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(d) @ S) / sigma_x) if with_scale else 1.0
    t = my - s * R @ mx
    return s, R, t.reshape(3)


def ate_rmse(est_xyz, gt_xyz, align=True, correct_scale=False):
    """Absolute trajectory error (RMSE of translation) after alignment.

    Mirrors evo's APE translation-part protocol (reference
    test_euroc.py:136-145).
    """
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    if align:
        s, R, t = umeyama_alignment(est, gt, with_scale=correct_scale)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return float(np.sqrt(np.mean(err ** 2))), est


def evaluate_ate(est_traj, gt_traj, align=True, correct_scale=False, max_dt=0.02):
    """Associate trajectories by timestamp, then ATE.

    est_traj/gt_traj: [N, 8] TUM rows (or (stamps, xyz) tuples).
    Returns dict with rmse/mean/median/std, matched count.
    """
    if isinstance(est_traj, tuple):
        ts_e, xyz_e = est_traj
    else:
        ts_e, xyz_e, _ = tum_trajectory_to_matrix(est_traj)
    if isinstance(gt_traj, tuple):
        ts_g, xyz_g = gt_traj
    else:
        ts_g, xyz_g, _ = tum_trajectory_to_matrix(gt_traj)

    # timestamp association — stamps that look like nanoseconds (EuRoC CSVs)
    # are normalized to seconds so max_dt means seconds for every dataset
    ts_e = np.asarray(ts_e, np.float64)
    ts_g = np.asarray(ts_g, np.float64)
    if ts_e.size and np.median(np.abs(ts_e)) > 1e14:
        ts_e = ts_e * 1e-9
    if ts_g.size and np.median(np.abs(ts_g)) > 1e14:
        ts_g = ts_g * 1e-9
    matches = []
    for i, t in enumerate(ts_e):
        j = int(np.argmin(np.abs(ts_g - t)))
        if abs(ts_g[j] - t) < max_dt:
            matches.append((i, j))
    association = "timestamp"
    if len(matches) < 3:
        # stamps are incompatible: index association is only well-defined
        # when the trajectories correspond frame-for-frame — anything else
        # would silently return a plausible-looking ATE for a
        # misassociation, so refuse instead
        if len(ts_e) != len(ts_g):
            raise ValueError(
                f"trajectory association failed: {len(matches)} timestamp "
                f"matches and unequal lengths ({len(ts_e)} vs {len(ts_g)})"
            )
        association = "index"
        matches = list(zip(range(len(ts_e)), range(len(ts_g))))

    ie, ig = map(np.asarray, zip(*matches))
    est = xyz_e[ie]
    gt = xyz_g[ig]
    rmse, est_aligned = ate_rmse(est, gt, align=align, correct_scale=correct_scale)
    err = np.linalg.norm(est_aligned - gt, axis=1)
    return {
        "rmse": rmse,
        "association": association,
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "matches": len(matches),
    }


def rpe(est_poses, gt_poses, delta=1):
    """Relative pose error over frame gaps of `delta`.

    est_poses/gt_poses: [N, 4, 4] homogeneous matrices.
    Returns (trans_rmse, rot_rmse_deg).
    """
    est = np.asarray(est_poses)
    gt = np.asarray(gt_poses)
    n = len(est) - delta
    terr, rerr = [], []
    for i in range(n):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(e[:3, 3]))
        ang = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerr.append(np.degrees(np.arccos(ang)))
    return float(np.sqrt(np.mean(np.square(terr)))), float(np.sqrt(np.mean(np.square(rerr))))


def kitti_metrics(est_xyz, gt_xyz, lengths=(100, 200, 300, 400, 500, 600, 700, 800)):
    """KITTI-style average translational drift (% per segment length)."""
    gt = np.asarray(gt_xyz, np.float64)
    est = np.asarray(est_xyz, np.float64)
    dists = np.concatenate([[0], np.cumsum(np.linalg.norm(np.diff(gt, axis=0), axis=1))])
    errs = []
    for L in lengths:
        for i in range(len(gt)):
            js = np.where(dists >= dists[i] + L)[0]
            if len(js) == 0:
                break
            j = js[0]
            e_rel = est[j] - est[i]
            g_rel = gt[j] - gt[i]
            errs.append(np.linalg.norm(e_rel - g_rel) / L)
    return float(np.mean(errs) * 100.0) if errs else float("nan")


def evaluate_tartanair(est_xyz, gt_xyz):
    """Scale-aligned ATE (tartanair_tools protocol)."""
    rmse, _ = ate_rmse(est_xyz, gt_xyz, align=True, correct_scale=True)
    return {"ate_score": rmse}
