"""The port's tracking slice against the JAX engine on the CPU.

One module-scoped run feeds the same 10 synthetic frames (tests/test_engine's
synth_frame and configuration) through the JAX Droid and the port's Droid,
with the JAX ``init_params(seed=0)`` weights carried over by
params_from_jax.  Tolerances:
- keyframe counts and edge lists: identical after every frame;
- poses after every frame: 1e-3 (random weights make the update operator's
  output sensitive to float32 summation order, and 10 frames of BA
  compound it; the single-call test below holds 1e-4);
- one update_fused call from one identical state: 1e-4 on poses and
  disparities, and on the culling distance relative to its size.
"""
import jax
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.engine import Droid as JDroid
from droid_slam_reserch_tpu.engine.droid import init_params as jax_init_params
from droid_slam_reserch_tpu_torch.engine import Droid as TDroid
from droid_slam_reserch_tpu_torch.models import params_from_jax
from droid_slam_reserch_tpu_torch.utils import DroidConfig as TConfig
from test_engine import INTR, make_config, synth_frame

torch.set_num_threads(1)
N_FRAMES = 10


def torch_config(**kw):
    cfg = make_config(**kw)
    return TConfig(**{k: getattr(cfg, k) for k in TConfig.__dataclass_fields__})


def _snapshot(d):
    g, v = d.frontend.graph, d.video
    t = v.counter
    return t, g.ii.copy(), g.jj.copy(), np.asarray(v.poses[:t]).copy()


@pytest.fixture(scope="module")
def runs():
    params = jax.tree_util.tree_map(np.asarray, jax_init_params(make_config(), seed=0))
    jd = JDroid(make_config(), params=params)
    td = TDroid(torch_config(), params=params_from_jax(params), device="cpu")
    rng = np.random.RandomState(0)
    hist = []
    for t in range(N_FRAMES):
        img = synth_frame(t, rng)
        jd.track(float(t), img, intrinsics=INTR)
        td.track(float(t), img, intrinsics=INTR)
        hist.append((_snapshot(jd), _snapshot(td)))
    return jd, td, hist


def test_keyframes_and_edges_every_frame(runs):
    _, _, hist = runs
    for (tj, iij, jjj, _), (tt, iit, jjt, _) in hist:
        assert tj == tt
        np.testing.assert_array_equal(iit, iij)
        np.testing.assert_array_equal(jjt, jjj)
    assert hist[-1][0][0] >= 5 and len(hist[-1][0][1]) > 0   # initialised, edges exist


def test_poses_every_frame(runs):
    _, _, hist = runs
    for (_, _, _, pj), (_, _, _, pt) in hist:
        np.testing.assert_allclose(pt, pj, atol=1e-3)


def _copy_state(jd, td):
    """Load the JAX engine's video and graph state into the port's."""
    jv, tv, jg, tg = jd.video, td.video, jd.frontend.graph, td.frontend.graph
    for k in ("poses", "disps", "disps_sens", "intrinsics", "damping", "nets", "inps"):
        getattr(tv, k).copy_(torch.from_numpy(np.array(getattr(jv, k))))
    tv.fmaps.copy_(torch.from_numpy(np.array(jv.fmaps)))
    tv.counter = jv.counter
    for k in ("ii", "jj", "age", "ii_inac", "jj_inac", "ii_bad", "jj_bad"):
        setattr(tg, k, getattr(jg, k).copy())
    for k in ("net", "target", "weight", "target_inac", "weight_inac"):
        setattr(tg, k, torch.from_numpy(np.array(getattr(jg, k))))
    td.frontend.t1 = jd.frontend.t1


def test_one_update_fused_call_from_identical_state(runs):
    jd, td, _ = runs
    _copy_state(jd, td)
    t1 = jd.frontend.t1
    pair = (t1 - 3, t1 - 2)
    d_j = float(jd.frontend.graph.update_fused(1, use_inactive=True, cull_pair=pair))
    with torch.no_grad():
        d_t = td.frontend.graph.update_fused(1, use_inactive=True, cull_pair=pair)
    t = jd.video.counter
    np.testing.assert_allclose(td.video.poses[:t].numpy(), np.asarray(jd.video.poses[:t]),
                               atol=1e-4)
    np.testing.assert_allclose(td.video.disps[:t].numpy(), np.asarray(jd.video.disps[:t]),
                               atol=1e-4)
    np.testing.assert_allclose(td.frontend.graph.weight.numpy(),
                               np.asarray(jd.frontend.graph.weight), atol=1e-4)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-4)


def test_save_reconstruction(runs, tmp_path):
    _, td, _ = runs
    td.save_reconstruction(str(tmp_path))
    data = np.load(tmp_path / "reconstruction.npz")
    t = td.video.counter
    assert data["poses"].shape == (t, 7) and data["fmaps"].shape[0] == t
    assert np.isfinite(data["poses"]).all()


OUT_OF_SLICE = {"upsample": True, "stereo": True, "rgbd": True,
                "compute_dtype": "bfloat16", "vis_path": "viz"}


@pytest.mark.parametrize("flag", sorted(OUT_OF_SLICE))
def test_out_of_slice_options_raise(flag):
    with pytest.raises(NotImplementedError):
        TDroid(torch_config(**{flag: OUT_OF_SLICE[flag]}), device="cpu")


def test_terminate_is_slice_two_and_cuda_is_required():
    d = TDroid(torch_config(), device="cpu")
    for fn in (d.terminate, d.terminate_eva):
        with pytest.raises(NotImplementedError, match="slice 2"):
            fn()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TDroid(torch_config())
