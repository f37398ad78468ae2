"""Oracle gates on the port (tests/test_engine_oracle_gate's scene): the
port's Frontend / FactorGraph / BA, and its backend's update_lowmem, driven
with the oracle update operator, must recover the ground-truth trajectory
to ATE < 0.01 and match the JAX engine's poses within 1e-4 (both solve the
same problem in float32).  Disparities are held to 1e-3 relative: mono BA leaves the joint
scale of disparities and translations free up to the small damping, so
float32 rounding moves them along that direction more than the poses."""
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.eval.metrics import ate_rmse as jax_ate_rmse
from droid_slam_reserch_tpu_torch.eval import oracle
from droid_slam_reserch_tpu_torch.eval.metrics import ate_rmse
from test_engine_oracle_gate import OracleGraph as JOracleGraph
from test_engine_oracle_gate import cam_centers as jax_cam_centers
from test_engine_oracle_gate import drive_frontend as jax_drive_frontend
from test_engine_oracle_gate import gt_scene as jax_gt_scene

torch.set_num_threads(1)


def _gt_from_jax(pause_at=None):
    return tuple(torch.from_numpy(np.array(x)) for x in jax_gt_scene(pause_at))


@pytest.fixture(scope="module")
def gates():
    gt = _gt_from_jax()
    jv, jfront = jax_drive_frontend(jax_gt_scene())
    tv, tfront = oracle.drive_frontend(gt, device="cpu")
    return gt, (jv, jfront), (tv, tfront)


def test_port_frontend_oracle_ate(gates):
    gt, _, (tv, tfront) = gates
    T = oracle.T
    assert tfront.is_initialized and tv.counter == T
    err, _ = ate_rmse(oracle.cam_centers(tv.poses[:T]), oracle.cam_centers(gt[0]),
                      align=True, correct_scale=True)
    assert err < 0.01, err


def test_port_matches_jax_frontend(gates):
    _, (jv, jfront), (tv, tfront) = gates
    T = oracle.T
    assert jv.counter == tv.counter == T
    np.testing.assert_array_equal(tfront.graph.ii, jfront.graph.ii)
    np.testing.assert_array_equal(tfront.graph.jj, jfront.graph.jj)
    np.testing.assert_allclose(tv.poses[:T].numpy(), np.asarray(jv.poses[:T]), atol=1e-4)
    np.testing.assert_allclose(tv.disps[:T].numpy(), np.asarray(jv.disps[:T]), rtol=1e-3)


def test_ate_helper_matches_jax():
    rng = np.random.RandomState(0)
    a = rng.standard_normal((20, 3))
    b = 2.0 * a @ np.linalg.qr(rng.standard_normal((3, 3)))[0] + 0.01 * rng.standard_normal((20, 3))
    for scale in (False, True):
        assert np.isclose(ate_rmse(a, b, correct_scale=scale)[0],
                          jax_ate_rmse(a, b, correct_scale=scale)[0])
    np.testing.assert_allclose(oracle.cam_centers(torch.from_numpy(np.array(jax_gt_scene()[0]))),
                               jax_cam_centers(jax_gt_scene()[0]), atol=1e-6)


def test_port_culling_gate():
    """A ground-truth pause gives a near-zero flow distance: the port must
    cull exactly that keyframe and still hold the trajectory."""
    pause = 7
    gt = _gt_from_jax(pause_at=pause)
    v, front = oracle.drive_frontend(gt, device="cpu", keyframe_thresh=0.4)
    g = front.graph
    assert v.counter == oracle.T - 1
    assert sorted(set(range(oracle.T)) - set(g.slot2gt)) == [pause]
    err, _ = ate_rmse(oracle.cam_centers(v.poses[: v.counter]),
                      oracle.cam_centers(gt[0][torch.tensor(g.slot2gt)]),
                      align=True, correct_scale=True)
    assert err < 0.01, err


def test_port_backend_oracle_ate():
    """The backend gate (tests/test_engine_oracle_gate.py:163-177): a global
    proximity graph over the oracle frontend's keyframes, two update_lowmem
    steps, ATE < 0.01 and the JAX backend's poses within 1e-4."""
    gt = _gt_from_jax()
    tv, _ = oracle.drive_frontend(gt, device="cpu")
    graph = oracle.drive_backend(tv, gt, steps=2, itrs=2)
    T = oracle.T
    assert len(graph.ii) > T
    err, _ = ate_rmse(oracle.cam_centers(tv.poses[:T]), oracle.cam_centers(gt[0]),
                      align=True, correct_scale=True)
    assert err < 0.01, err

    jgt = jax_gt_scene()
    jv, _ = jax_drive_frontend(jgt)
    jg = JOracleGraph(jv, jgt, max_factors=16 * T)
    jg.add_proximity_factors(rad=2, nms=2, thresh=64.0, beta=0.3)
    jg.update_lowmem(steps=2, itrs=2)
    np.testing.assert_array_equal(graph.ii, jg.ii)
    np.testing.assert_allclose(tv.poses[:T].numpy(), np.asarray(jv.poses[:T]), atol=1e-4)
