"""RGB-D tracking in the port against the JAX engine on the CPU.

One module-scoped run feeds the same 8 frames with depth maps
(tests/test_engine's RGB-D sequence: synth_frame and a depth of 2 to 2.5,
its configuration with rgbd=True) through the JAX Droid and the port's
Droid, with the JAX ``init_params(seed=0)`` weights carried over by
params_from_jax.  Tolerances:
- the sensor disparities ``disps_sens`` after every frame, Video.set_slot's
  conversion of a depth map, and each new keyframe's disparity as the
  frontend seeds it from the sensor: 1e-6;
- keyframe counts and edge lists: identical after every frame;
- poses after every frame, and the trajectory, poses and disparities after
  terminate_eva: 1e-3;
- one update_fused call from one identical state: 1e-4.
"""
import jax
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.engine import Droid as JDroid
from droid_slam_reserch_tpu.engine.droid import init_params as jax_init_params
from droid_slam_reserch_tpu.engine.video import Video as JVideo
from droid_slam_reserch_tpu_torch.engine import Droid as TDroid
from droid_slam_reserch_tpu_torch.engine import Video as TVideo
from droid_slam_reserch_tpu_torch.models import params_from_jax
from test_engine import INTR, H, W, make_config, synth_frame
from test_torch_engine import _copy_state, _snapshot, torch_config

torch.set_num_threads(1)
N_FRAMES = 8
TOL = 1e-3


def rgbd_frames(n):
    rng = np.random.RandomState(2)
    out = []
    for t in range(n):
        depth = 2.0 + 0.5 * rng.rand(H, W).astype(np.float32)
        out.append((synth_frame(t, rng), depth))
    return out


def _record_seeds(d, seeds):
    """Wrap the frontend's update rounds: the first of a keyframe update
    (the one with a culling pair) records the new keyframe's disparity and
    sensor disparity as the frontend leaves them before the rounds."""
    run = d.frontend._run_updates

    def wrapped(rounds, t0=None, cull_pair=None):
        if cull_pair is not None:
            k, v = d.frontend.t1 - 1, d.video
            seeds.append((k, np.array(v.disps[k]), np.array(v.disps_sens[k])))
        return run(rounds, t0=t0, cull_pair=cull_pair)

    d.frontend._run_updates = wrapped


@pytest.fixture(scope="module")
def runs():
    params = jax.tree_util.tree_map(np.asarray, jax_init_params(make_config(), seed=0))
    # one device for the JAX backend refresh (the port has no sharded refresh)
    jd = JDroid(make_config(rgbd=True, refresh_shards=1), params=params)
    td = TDroid(torch_config(rgbd=True), params=params_from_jax(params), device="cpu")
    seeds = ([], [])
    _record_seeds(jd, seeds[0])
    _record_seeds(td, seeds[1])
    frames = rgbd_frames(N_FRAMES)
    hist = []
    for t, (img, depth) in enumerate(frames):
        jd.track(float(t), img, depth=depth, intrinsics=INTR)
        td.track(float(t), img, depth=depth, intrinsics=INTR)
        n = jd.video.counter
        hist.append((_snapshot(jd), _snapshot(td), np.array(jd.video.disps_sens[:n]),
                     td.video.disps_sens[:n].numpy().copy()))
    return jd, td, hist, frames, seeds


def test_disps_sens_every_frame(runs):
    _, _, hist, _, _ = runs
    for _, _, sj, st in hist:
        np.testing.assert_allclose(st, sj, atol=1e-6, rtol=0)
    assert (hist[-1][3] > 0).all()


def test_set_slot_depth_conversion():
    """A depth map with zeros and negative values: every 8th pixel from
    (3, 3), 1 / depth where positive, 0 elsewhere."""
    rng = np.random.RandomState(5)
    depth = (0.1 + 10.0 * rng.rand(H, W)).astype(np.float32)
    depth[rng.rand(H, W) < 0.3] = 0.0
    depth[rng.rand(H, W) < 0.1] *= -1.0
    jv, tv = JVideo(make_config(rgbd=True)), TVideo(torch_config(rgbd=True), "cpu")
    for v in (jv, tv):
        v.set_slot(3, 1.0, None, None, None, depth, None, None)
    sj, st = np.asarray(jv.disps_sens[3]), tv.disps_sens[3].numpy()
    np.testing.assert_allclose(st, sj, atol=1e-6, rtol=0)
    assert (st == 0).any() and (st > 0).any() and tv.disps_sens.dtype == torch.float32


def test_keyframes_and_edges_every_frame_rgbd(runs):
    jd, _, hist, _, _ = runs
    for (tj, iij, jjj, _), (tt, iit, jjt, _), _, _ in hist:
        assert tj == tt
        np.testing.assert_array_equal(iit, iij)
        np.testing.assert_array_equal(jjt, jjj)
    assert hist[-1][0][0] >= 5 and jd.frontend.is_initialized


def test_seeded_disparity_of_new_keyframes(runs):
    """Each keyframe update seeds the new keyframe's disparity from the
    sensor where the sensor has one (reference frontend.py:49-50)."""
    _, _, _, _, (sj, st) = runs
    assert len(st) == len(sj) >= 2
    for (kj, dj, sensj), (kt, dt, senst) in zip(sj, st):
        assert kj == kt
        np.testing.assert_allclose(dt, dj, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(dt, senst)        # the sensor is positive everywhere


def test_poses_every_frame_rgbd(runs):
    _, _, hist, _, _ = runs
    for (_, _, _, pj), (_, _, _, pt), _, _ in hist:
        np.testing.assert_allclose(pt, pj, atol=TOL)


def test_one_update_fused_call_rgbd(runs):
    """Two windowed rounds from one identical state: the BA takes the
    sensor disparities' terms."""
    jd, td, _, _, _ = runs
    _copy_state(jd, td)
    t1 = jd.frontend.t1
    pair = (t1 - 3, t1 - 2)
    d_j = float(jd.frontend.graph.update_fused(2, use_inactive=True, cull_pair=pair))
    with torch.no_grad():
        d_t = td.frontend.graph.update_fused(2, use_inactive=True, cull_pair=pair)
    t = jd.video.counter
    np.testing.assert_allclose(td.video.poses[:t].numpy(), np.asarray(jd.video.poses[:t]),
                               atol=1e-4)
    np.testing.assert_allclose(td.video.disps[:t].numpy(), np.asarray(jd.video.disps[:t]),
                               atol=1e-4)
    np.testing.assert_allclose(td.frontend.graph.weight.numpy(),
                               np.asarray(jd.frontend.graph.weight), atol=1e-4)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-4)


def test_terminate_eva_rgbd_without_normalize(runs):
    """The backend's scale gauge comes from the sensor: neither engine
    normalizes an RGB-D map."""
    jd, td, _, frames, _ = runs
    _copy_state(jd, td)
    t = jd.video.counter
    stream = [(float(k), img, INTR) for k, (img, _) in enumerate(frames)]
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for cls in (JVideo, TVideo):
            mp.setattr(cls, "normalize", lambda self, _cls=cls: calls.append(_cls))
        traj_j = jd.terminate_eva(iter(stream))
        traj_t = td.terminate_eva(iter(stream))
    assert calls == []
    assert traj_t.shape == traj_j.shape == (N_FRAMES, 7) and np.isfinite(traj_t).all()
    np.testing.assert_allclose(traj_t, traj_j, atol=TOL)
    np.testing.assert_allclose(td.video.poses[:t].numpy(), np.asarray(jd.video.poses[:t]),
                               atol=TOL)
    np.testing.assert_allclose(td.video.disps[:t].numpy(), np.asarray(jd.video.disps[:t]),
                               atol=TOL, rtol=TOL)
