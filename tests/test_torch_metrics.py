"""The port's eval/metrics.py against the JAX package's, on seeded
trajectories: every metric, the timestamp association (seconds, nanosecond
stamps, the index fallback and its refusal), and the cases of
tests/test_data_eval.py and tests/test_ate_gate.py that exercise metrics.
Both are numpy; they agree within 1e-9."""
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from droid_slam_reserch_tpu.eval import metrics as jm
from droid_slam_reserch_tpu_torch.eval import metrics as tm

ATOL = 1e-9


def _tum_rows(n, seed, t0=0.0, dt=1.0):
    rng = np.random.RandomState(seed)
    ts = t0 + dt * np.arange(n, dtype=np.float64)
    xyz = np.cumsum(rng.randn(n, 3) * 0.1, axis=0)
    q = Rotation.from_rotvec(rng.randn(n, 3) * 0.2).as_quat()     # x y z w
    return np.concatenate([ts[:, None], xyz, q], 1)


def _similar(est_of, seed):
    """gt rows and est rows = a similarity of gt plus noise."""
    gt = _tum_rows(40, seed)
    R = Rotation.from_rotvec([0.1, -0.3, 0.2]).as_matrix()
    rng = np.random.RandomState(seed + 1)
    est = gt.copy()
    est[:, 1:4] = est_of(gt[:, 1:4], R) + 0.01 * rng.randn(40, 3)
    return est, gt


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, str):
        assert a == b
    else:
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_tum_trajectory_to_matrix():
    rows = _tum_rows(12, 0)
    _close(tm.tum_trajectory_to_matrix(rows), jm.tum_trajectory_to_matrix(rows))


@pytest.mark.parametrize("with_scale", [False, True])
def test_umeyama_and_ate_rmse(with_scale):
    est, gt = _similar(lambda x, R: 1.7 * x @ R.T + [1.0, -2.0, 0.5], 3)
    _close(tm.umeyama_alignment(est[:, 1:4], gt[:, 1:4], with_scale),
           jm.umeyama_alignment(est[:, 1:4], gt[:, 1:4], with_scale))
    for align in (False, True):
        _close(tm.ate_rmse(est[:, 1:4], gt[:, 1:4], align, with_scale),
               jm.ate_rmse(est[:, 1:4], gt[:, 1:4], align, with_scale))


@pytest.mark.parametrize("case", ["seconds", "nanoseconds", "offset", "tuples", "index"])
def test_evaluate_ate(case):
    est, gt = _similar(lambda x, R: 2.0 * x @ R.T + 5.0, 5)
    kw = {"align": True, "correct_scale": True}
    if case == "nanoseconds":       # EuRoC CSV stamps against seconds
        gt[:, 0] = 1.4e9 + gt[:, 0] * 0.05
        est[:, 0] = gt[:, 0] * 1e9
        kw["max_dt"] = 0.1
    elif case == "offset":          # stamps 10 ms apart, half of them unmatched
        est[:, 0] += 0.01
        gt = gt[::2]
    elif case == "index":           # incompatible stamps, equal lengths
        est[:, 0] += 1000.0
    if case == "tuples":
        e, g = (est[:, 0], est[:, 1:4]), (gt[:, 0], gt[:, 1:4])
        _close(tm.evaluate_ate(e, g, **kw), jm.evaluate_ate(e, g, **kw))
        return
    res = tm.evaluate_ate(est, gt, **kw)
    _close(res, jm.evaluate_ate(est, gt, **kw))
    assert res["association"] == ("index" if case == "index" else "timestamp")


def test_association_failure_raises():
    """tests/test_ate_gate.py's case: incompatible stamps with unequal
    lengths raise the same ValueError in both."""
    xyz = np.random.RandomState(0).standard_normal((10, 3))
    args = ((np.arange(10) * 1000.0, xyz), (np.arange(7).astype(float), xyz[:7]))
    with pytest.raises(ValueError, match="association failed") as port:
        tm.evaluate_ate(*args)
    with pytest.raises(ValueError, match="association failed") as jax_:
        jm.evaluate_ate(*args)
    assert str(port.value) == str(jax_.value)


def _poses(n, seed):
    rng = np.random.RandomState(seed)
    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, :3, :3] = Rotation.from_rotvec(rng.randn(n, 3) * 0.3).as_matrix()
    T[:, :3, 3] = np.cumsum(rng.randn(n, 3), axis=0)
    return T


@pytest.mark.parametrize("delta", [1, 3])
def test_rpe(delta):
    est, gt = _poses(25, 0), _poses(25, 1)
    _close(tm.rpe(est, gt, delta), jm.rpe(est, gt, delta))
    _close(tm.rpe(gt, gt, delta), jm.rpe(gt, gt, delta))


def test_kitti_metrics():
    rng = np.random.RandomState(2)
    gt = np.cumsum(np.abs(rng.randn(600, 3)), axis=0)
    est = gt + np.cumsum(0.01 * rng.randn(600, 3), axis=0)
    _close(tm.kitti_metrics(est, gt), jm.kitti_metrics(est, gt))
    _close(tm.kitti_metrics(est, gt, lengths=(100, 200)), jm.kitti_metrics(est, gt, lengths=(100, 200)))
    # tests/test_data_eval.py's case: no drift, and a path shorter than every length
    line = np.zeros((500, 3))
    line[:, 0] = np.arange(500)
    assert tm.kitti_metrics(line, line, lengths=(100, 200)) < 1e-9
    assert np.isnan(tm.kitti_metrics(line[:50], line[:50])) and np.isnan(jm.kitti_metrics(line[:50], line[:50]))


def test_evaluate_tartanair():
    est, gt = _similar(lambda x, R: 0.5 * x @ R.T - 1.0, 7)
    _close(tm.evaluate_tartanair(est[:, 1:4], gt[:, 1:4]),
           jm.evaluate_tartanair(est[:, 1:4], gt[:, 1:4]))


def test_test_data_eval_cases():
    """tests/test_data_eval.py's metric cases through the port: a known
    similarity recovered, ATE zero after Sim3 alignment, index-equal stamps
    associated, RPE of identical poses zero."""
    rng = np.random.RandomState(0)
    x = rng.randn(50, 3)
    R_gt = Rotation.from_rotvec([0.3, -0.2, 0.5]).as_matrix()
    y = (1.7 * (R_gt @ x.T)).T + np.array([1.0, -2.0, 0.5])
    s, R, t = tm.umeyama_alignment(x, y, with_scale=True)
    np.testing.assert_allclose(s, 1.7, rtol=1e-6)
    np.testing.assert_allclose(R, R_gt, atol=1e-6)
    np.testing.assert_allclose(t, [1.0, -2.0, 0.5], atol=1e-6)

    gt = np.cumsum(np.random.RandomState(1).randn(30, 3) * 0.1, axis=0)
    est = (2.0 * (R_gt @ gt.T)).T + 5.0
    assert tm.ate_rmse(est, gt, align=True, correct_scale=True)[0] < 1e-7
    assert tm.ate_rmse(est, gt, align=True, correct_scale=False)[0] > 0.1

    ts = np.arange(20, dtype=np.float64)
    rows = np.concatenate([ts[:, None], np.cumsum(np.ones((20, 3)), 0),
                           np.tile([0, 0, 0, 1.0], (20, 1))], 1)
    shifted = rows.copy()
    shifted[:, 1:4] += 0.01
    res = tm.evaluate_ate(shifted, rows, align=False)
    np.testing.assert_allclose(res["rmse"], np.sqrt(3) * 0.01, rtol=1e-6)
    assert res["matches"] == 20

    T = np.tile(np.eye(4), (10, 1, 1))
    T[:, 0, 3] = np.arange(10)
    t_err, r_err = tm.rpe(T, T)
    assert t_err < 1e-12 and r_err < 1e-6
