"""The port's Droid.terminate and Droid.terminate_eva against the JAX Droid
on the CPU, on tests/test_engine's 10-frame sequence and configuration
(backend_steps_first = backend_steps_second = 1), with the JAX
``init_params(seed=0)`` weights carried over by params_from_jax.

Each test tracks a fresh pair of engines, then terminates both.  Poses,
disparities and trajectories are held to 1e-3, as tracking is (random
weights make the update operator sensitive to float32 summation order).
"""
import jax
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.engine import Droid as JDroid
from droid_slam_reserch_tpu.engine.droid import init_params as jax_init_params
from droid_slam_reserch_tpu_torch import ops
from droid_slam_reserch_tpu_torch.engine import Droid as TDroid
from droid_slam_reserch_tpu_torch.engine import factor_graph as tfg
from droid_slam_reserch_tpu_torch.models import params_from_jax
from droid_slam_reserch_tpu_torch.utils import DroidConfig as TConfig
from test_engine import INTR, make_config, synth_frame

torch.set_num_threads(1)
N_FRAMES = 10
TOL = 1e-3


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(np.asarray, jax_init_params(make_config(), seed=0))


def _stream():
    rng = np.random.RandomState(0)
    return [(float(t), synth_frame(t, rng), INTR) for t in range(N_FRAMES)]


def _tracked_pair(params):
    # one device for the JAX backend refresh (the port has no sharded refresh)
    cfg = make_config(refresh_shards=1)
    jd = JDroid(cfg, params=params)
    td = TDroid(TConfig(**{k: getattr(cfg, k) for k in TConfig.__dataclass_fields__}),
                params=params_from_jax(params), device="cpu")
    for tstamp, img, intr in _stream():
        jd.track(tstamp, img, intrinsics=intr)
        td.track(tstamp, img, intrinsics=intr)
    assert jd.video.counter == td.video.counter >= 5
    return jd, td


def test_terminate_matches_jax(params, tmp_path):
    jd, td = _tracked_pair(params)
    t = jd.video.counter
    jd.terminate()
    td.terminate()
    assert not hasattr(td, "frontend")
    np.testing.assert_allclose(td.video.poses[:t].numpy(), np.asarray(jd.video.poses[:t]),
                               atol=TOL)
    np.testing.assert_allclose(td.video.disps[:t].numpy(), np.asarray(jd.video.disps[:t]),
                               atol=TOL, rtol=TOL)
    assert td.video.dirty[:t].all()
    td.save_backend_finished_poses(str(tmp_path))
    saved = np.load(tmp_path / "backend_finished_poses.npy")
    np.testing.assert_array_equal(saved, td.video.poses[:t].numpy())


def test_terminate_eva_matches_jax(params):
    jd, td = _tracked_pair(params)
    t = jd.video.counter
    traj_j = jd.terminate_eva(iter(_stream()))
    ops.reset_counts()
    tfg.reset_corr_rounds()
    traj_t = td.terminate_eva(iter(_stream()))
    assert traj_t.shape == traj_j.shape == (N_FRAMES, 7)
    assert np.isfinite(traj_t).all()
    np.testing.assert_allclose(traj_t, traj_j, atol=TOL)
    np.testing.assert_allclose(td.video.poses[:t].numpy(), np.asarray(jd.video.poses[:t]),
                               atol=TOL)
    assert td.video.counter == t                      # the filler's slots are released
    # the filler's one chunk: 6 motion-only rounds through the window cache
    assert tfg.corr_rounds()["windowed"] + tfg.corr_rounds()["fallback"] == 6
    counts = ops.counts()
    assert counts["corr_build_windows"] == (0, 1)
    assert counts["corr_build"][1] >= 2                # the backend's chunks
