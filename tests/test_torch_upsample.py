"""cfg.upsample in the port against the JAX package on the CPU.

- cvx_upsample and upsample_disp against the Flax module's functions on
  seeded inputs, within 1e-5;
- Droid(upsample=True) against the JAX Droid on tests/test_engine's 8-frame
  64x96 sequence and configuration, with the JAX ``init_params(seed=0)``
  weights: video.disps_up of the tracked keyframes after track (the
  frontend's update_fused) and again after terminate (update_lowmem's
  chunks), within tests/test_torch_terminate.py's 1e-3; upsample=True
  allocates disps_up at the first update, and upsample=False never does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.engine import Droid as JDroid
from droid_slam_reserch_tpu.engine.droid import init_params as jax_init_params
from droid_slam_reserch_tpu.models import update as jupdate
from droid_slam_reserch_tpu_torch.engine import Droid as TDroid
from droid_slam_reserch_tpu_torch.models import cvx_upsample, params_from_jax, upsample_disp
from test_engine import INTR, synth_frame
from test_torch_engine import torch_config

torch.set_num_threads(1)
N_FRAMES = 8
TOL = 1e-3


def test_cvx_upsample_matches_jax():
    rng = np.random.RandomState(0)
    data = rng.randn(2, 5, 7, 3).astype(np.float32)
    mask = (3 * rng.randn(2, 5, 7, 576)).astype(np.float32)
    ref = np.asarray(jupdate.cvx_upsample(jnp.asarray(data), jnp.asarray(mask)))
    got = cvx_upsample(torch.from_numpy(data), torch.from_numpy(mask)).numpy()
    assert got.shape == ref.shape == (2, 40, 56, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_upsample_disp_matches_jax():
    rng = np.random.RandomState(1)
    disp = rng.rand(1, 3, 8, 12).astype(np.float32)
    mask = rng.randn(1, 3, 8, 12, 576).astype(np.float32)
    ref = np.asarray(jupdate.upsample_disp(jnp.asarray(disp), jnp.asarray(mask)))
    got = upsample_disp(torch.from_numpy(disp), torch.from_numpy(mask)).numpy()
    assert got.shape == ref.shape == (1, 3, 64, 96)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.fixture(scope="module")
def tracked():
    # one device for the JAX backend refresh (the port has no sharded refresh)
    cfg = torch_config(upsample=True, refresh_shards=1)
    from test_engine import make_config

    params = jax.tree_util.tree_map(np.asarray, jax_init_params(make_config(), seed=0))
    jd = JDroid(make_config(upsample=True, refresh_shards=1), params=params)
    td = TDroid(cfg, params=params_from_jax(params), device="cpu")
    rng = np.random.RandomState(0)
    for t in range(N_FRAMES):
        img = synth_frame(t, rng)
        jd.track(float(t), img, intrinsics=INTR)
        td.track(float(t), img, intrinsics=INTR)
    return jd, td


def _compare(jd, td):
    t = jd.video.counter
    assert td.video.counter == t >= 5
    up_t = td.video.disps_up[:t].numpy().copy()
    up_j = np.asarray(jd.video.disps_up[:t])
    assert up_t.shape == (t, 64, 96) and np.isfinite(up_t).all()
    np.testing.assert_allclose(up_t, up_j, atol=TOL, rtol=TOL)
    return up_t


def test_disps_up_after_track_and_terminate(tracked):
    jd, td = tracked
    after_track = _compare(jd, td)
    # every keyframe the frontend updated holds its 8x disparity
    assert (np.abs(after_track).reshape(len(after_track), -1).max(1) > 0).all()
    jd.terminate()
    td.terminate()
    after_terminate = _compare(jd, td)
    assert not np.array_equal(after_terminate, after_track)   # the backend rewrote them


def test_upsample_off_leaves_disps_up_unallocated():
    td = TDroid(torch_config(), device="cpu")
    rng = np.random.RandomState(0)
    for t in range(6):
        td.track(float(t), synth_frame(t, rng), intrinsics=INTR)
    assert td.frontend.is_initialized and td.video.disps_up is None


def test_upsample_allocates_disps_up_lazily():
    td = TDroid(torch_config(upsample=True), device="cpu")
    assert td.frontend.graph.upsample and td.cfg.upsample
    assert td.video.disps_up is None      # no buffer until an update writes one
