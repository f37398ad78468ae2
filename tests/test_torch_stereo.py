"""Stereo tracking in the port against the JAX engine on the CPU.

One module-scoped run feeds the same 8 stereo frames (tests/test_engine's
synth_frame as the left image, the right one rolled 2 px, its configuration
with stereo=True) through the JAX Droid and the port's Droid, with the JAX
``init_params(seed=0)`` weights carried over by params_from_jax.
Tolerances, as tests/test_torch_engine.py holds mono:
- keyframe counts and edge lists: identical after every frame, with the
  stereo self-edges (i, i) among them;
- poses after every frame, the filler's trajectories and the poses and
  disparities after terminate_eva: 1e-3;
- both cameras' features in Video.fmaps: 1e-4;
- one update_fused call and one update_lowmem step from one identical
  stereo state: 1e-4 on poses, disparities and weights.
"""
import jax
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.engine import Droid as JDroid
from droid_slam_reserch_tpu.engine.droid import init_params as jax_init_params
from droid_slam_reserch_tpu.engine.factor_graph import FactorGraph as JFactorGraph
from droid_slam_reserch_tpu.engine.video import Video as JVideo
from droid_slam_reserch_tpu_torch import ops
from droid_slam_reserch_tpu_torch.engine import Droid as TDroid
from droid_slam_reserch_tpu_torch.engine import Video as TVideo
from droid_slam_reserch_tpu_torch.engine import factor_graph as tfg
from droid_slam_reserch_tpu_torch.engine.net_ops import update_apply
from droid_slam_reserch_tpu_torch.models import params_from_jax
from test_engine import INTR, make_config, synth_frame
from test_torch_engine import _copy_state, _snapshot, torch_config

torch.set_num_threads(1)
N_FRAMES = 8
TOL = 1e-3


def stereo_frames(n):
    rng = np.random.RandomState(1)
    out = []
    for t in range(n):
        left = synth_frame(t, rng)
        out.append(np.stack([left, np.roll(left, -2, axis=1)]))
    return out


@pytest.fixture(scope="module")
def runs():
    params = jax.tree_util.tree_map(np.asarray, jax_init_params(make_config(), seed=0))
    # one device for the JAX backend refresh (the port has no sharded refresh)
    jd = JDroid(make_config(stereo=True, refresh_shards=1), params=params)
    td = TDroid(torch_config(stereo=True), params=params_from_jax(params), device="cpu")
    frames = stereo_frames(N_FRAMES)
    hist = []
    for t, img in enumerate(frames):
        jd.track(float(t), img, intrinsics=INTR)
        td.track(float(t), img, intrinsics=INTR)
        hist.append((_snapshot(jd), _snapshot(td)))
    return jd, td, hist, frames


def test_keyframes_and_edges_every_frame_stereo(runs):
    jd, _, hist, _ = runs
    for (tj, iij, jjj, _), (tt, iit, jjt, _) in hist:
        assert tj == tt
        np.testing.assert_array_equal(iit, iij)
        np.testing.assert_array_equal(jjt, jjj)
    _, ii, jj, _ = hist[-1][1]
    assert hist[-1][0][0] >= 5 and jd.frontend.is_initialized
    assert (ii == jj).sum() >= 3                      # the stereo self-edges


def test_poses_every_frame_stereo(runs):
    _, _, hist, _ = runs
    for (_, _, _, pj), (_, _, _, pt) in hist:
        np.testing.assert_allclose(pt, pj, atol=TOL)


def test_fmaps_of_both_cameras(runs):
    jd, td, _, _ = runs
    t = jd.video.counter
    assert tuple(td.video.fmaps.shape[1:]) == tuple(jd.video.fmaps.shape[1:]) == (2, 8, 12, 128)
    np.testing.assert_allclose(td.video.fmaps[:t].numpy(), np.asarray(jd.video.fmaps[:t]),
                               atol=1e-4)
    assert (td.video.fmaps[:t, 0] - td.video.fmaps[:t, 1]).abs().max() > 0.1


def test_one_update_fused_call_stereo(runs):
    """Two windowed rounds over a graph with self-edges: their targets take
    the right camera's features (``cams``), padding slots included."""
    jd, td, _, _ = runs
    _copy_state(jd, td)
    g = td.frontend.graph
    assert (g.ii == g.jj).any()
    t1 = jd.frontend.t1
    pair = (t1 - 3, t1 - 2)
    d_j = float(jd.frontend.graph.update_fused(2, use_inactive=True, cull_pair=pair))
    ops.reset_counts()
    tfg.reset_corr_rounds()
    with torch.no_grad():
        d_t = g.update_fused(2, use_inactive=True, cull_pair=pair)
    t = jd.video.counter
    np.testing.assert_allclose(td.video.poses[:t].numpy(), np.asarray(jd.video.poses[:t]),
                               atol=1e-4)
    np.testing.assert_allclose(td.video.disps[:t].numpy(), np.asarray(jd.video.disps[:t]),
                               atol=1e-4)
    np.testing.assert_allclose(g.weight.numpy(), np.asarray(jd.frontend.graph.weight), atol=1e-4)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-4)
    assert ops.counts()["corr_build_windows"] == (0, 1)
    assert tfg.corr_rounds() == {"windowed": 2, "fallback": 0}


def test_update_lowmem_stereo(runs):
    """One backend step over a proximity graph with a self-edge on every
    keyframe, from one identical state."""
    jd, td, _, _ = runs
    _copy_state(jd, td)
    jv, tv, cfg = jd.video, td.video, jd.cfg
    t = jv.counter
    jg = JFactorGraph(jv, jd.applies["update"], jd.params, max_factors=16 * t)
    tg = tfg.FactorGraph(tv, update_apply, td.net.update, max_factors=16 * t)
    for g in (jg, tg):
        g.add_proximity_factors(rad=cfg.backend_radius, nms=cfg.backend_nms,
                                thresh=cfg.backend_thresh, beta=cfg.beta)
    np.testing.assert_array_equal(tg.ii, jg.ii)
    np.testing.assert_array_equal(tg.jj, jg.jj)
    assert (tg.ii == tg.jj).sum() == t
    jg.update_lowmem(steps=1)
    with torch.no_grad():
        tg.update_lowmem(steps=1)
    np.testing.assert_allclose(tv.poses[:t].numpy(), np.asarray(jv.poses[:t]), atol=1e-4)
    np.testing.assert_allclose(tv.disps[:t].numpy(), np.asarray(jv.disps[:t]), atol=1e-4)
    np.testing.assert_allclose(tg.weight.numpy(), np.asarray(jg.weight), atol=1e-4)


@pytest.mark.parametrize("stereo", [False, True])
@pytest.mark.parametrize("r", [2, 3])
def test_neighbourhood_edges_match_jax(stereo, r):
    """add_neighborhood_factors over frames [2, 9): a stereo graph keeps
    c < |i - j| <= r with c = 1, so it has no |i - j| = 1 pairs either."""
    jg = JFactorGraph(JVideo(make_config(stereo=stereo)), None, None)
    tg = tfg.FactorGraph(TVideo(torch_config(stereo=stereo), "cpu"), None, None)
    jg.add_neighborhood_factors(2, 9, r=r)
    tg.add_neighborhood_factors(2, 9, r=r)
    np.testing.assert_array_equal(tg.ii, jg.ii)
    np.testing.assert_array_equal(tg.jj, jg.jj)
    d = np.abs(tg.ii - tg.jj)
    assert d.min() == (2 if stereo else 1) and d.max() == r


@pytest.fixture(scope="module")
def terminated(runs):
    """terminate_eva over the stereo frames from one identical state; the
    backend's scale gauge must not normalize a stereo map."""
    jd, td, _, frames = runs
    _copy_state(jd, td)
    stream = [(float(t), img, INTR) for t, img in enumerate(frames)]
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for cls in (JVideo, TVideo):
            mp.setattr(cls, "normalize", lambda self, _cls=cls: calls.append(_cls))
        traj_j = jd.terminate_eva(iter(stream))
        traj_t = td.terminate_eva(iter(stream))
    return jd, td, traj_j, traj_t, calls


def test_terminate_eva_stereo(terminated):
    jd, td, traj_j, traj_t, calls = terminated
    t = jd.video.counter
    assert calls == []
    assert traj_t.shape == traj_j.shape == (N_FRAMES, 7) and np.isfinite(traj_t).all()
    np.testing.assert_allclose(traj_t, traj_j, atol=TOL)
    np.testing.assert_allclose(td.video.poses[:t].numpy(), np.asarray(jd.video.poses[:t]),
                               atol=TOL)
    np.testing.assert_allclose(td.video.disps[:t].numpy(), np.asarray(jd.video.disps[:t]),
                               atol=TOL, rtol=TOL)
    assert td.video.counter == t                      # the filler's slots are released


def test_filler_mono_frames_into_stereo_buffer(terminated):
    """[1, H, W, 3] frames fill a stereo buffer: their features broadcast to
    both cameras (set_slot), as in the JAX package."""
    jd, td, _, _, _ = terminated
    frames = stereo_frames(N_FRAMES)
    stream = [(t + 0.5, img[:1], INTR) for t, img in enumerate(frames)]
    with torch.no_grad():
        pj = jd.traj_filler(iter(stream))
        pt = td.traj_filler(iter(stream))
    assert pt.shape == pj.shape == (N_FRAMES, 7) and np.isfinite(pt).all()
    np.testing.assert_allclose(pt, pj, atol=TOL)
