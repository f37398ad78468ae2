"""The port's engine against the JAX engine on the CPU.

One module-scoped run feeds the same 10 synthetic frames (tests/test_engine's
synth_frame and configuration) through the JAX Droid and the port's Droid,
with the JAX ``init_params(seed=0)`` weights carried over by
params_from_jax.  The JAX engine runs its CPU ``flat`` correlation, which
computes the same function as the port's windowed path (K4/K5 with the K2+K3
fallback).  Tolerances:
- keyframe counts and edge lists: identical after every frame;
- Video.dirty: identical after every frame (cleared after each, as a viewer
  does);
- poses after every frame: 1e-3 (random weights make the update operator's
  output sensitive to float32 summation order, and 10 frames of BA
  compound it; the single-call tests below hold 1e-4);
- one update_fused call (windowed, or forced onto the fallback) and one
  update_lowmem step from one identical state: 1e-4 on poses, disparities
  and weights, and on the culling distance relative to its size;
- altcorr_pyramid against the JAX function and against K2 + K3: 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.engine import Droid as JDroid
from droid_slam_reserch_tpu.engine.droid import init_params as jax_init_params
from droid_slam_reserch_tpu.engine.factor_graph import FactorGraph as JFactorGraph
from droid_slam_reserch_tpu.ops import corr as jcorr
from droid_slam_reserch_tpu_torch import ops
from droid_slam_reserch_tpu_torch.engine import Droid as TDroid
from droid_slam_reserch_tpu_torch.engine import factor_graph as tfg
from droid_slam_reserch_tpu_torch.engine.net_ops import update_apply
from droid_slam_reserch_tpu_torch.models import params_from_jax
from droid_slam_reserch_tpu_torch.ops import corr as tcorr
from droid_slam_reserch_tpu_torch.ops.cuda_corr import corr_build_plain, corr_lookup_plain
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
    # one device for the JAX backend refresh (the port has no sharded refresh)
    jd = JDroid(make_config(refresh_shards=1), params=params)
    td = TDroid(torch_config(), params=params_from_jax(params), device="cpu")
    rng = np.random.RandomState(0)
    hist = []
    for t in range(N_FRAMES):
        img = synth_frame(t, rng)
        jd.track(float(t), img, intrinsics=INTR)
        td.track(float(t), img, intrinsics=INTR)
        # each frame's dirty flags, then cleared as a viewer that drew them would
        dirty = (jd.video.dirty.copy(), td.video.dirty.copy(), jd.frontend.is_initialized)
        jd.video.dirty[:] = False
        td.video.dirty[:] = False
        hist.append((_snapshot(jd), _snapshot(td), dirty))
    return jd, td, hist


def test_keyframes_and_edges_every_frame(runs):
    _, _, hist = runs
    for (tj, iij, jjj, _), (tt, iit, jjt, _), _ in hist:
        assert tj == tt
        np.testing.assert_array_equal(iit, iij)
        np.testing.assert_array_equal(jjt, jjj)
    assert hist[-1][0][0] >= 5 and len(hist[-1][0][1]) > 0   # initialised, edges exist


def test_poses_every_frame(runs):
    _, _, hist = runs
    for (_, _, _, pj), (_, _, _, pt), _ in hist:
        np.testing.assert_allclose(pt, pj, atol=1e-3)


def test_dirty_flags_every_frame(runs):
    """Video.dirty, flag for flag, after each frame (cleared in between):
    the appended slot, all of [:t1] at initialisation, and [ii.min(), t1)
    after every later keyframe update."""
    _, _, hist = runs
    marked_by_frontend = 0
    for k, (_, _, (dj, dt, initialised)) in enumerate(hist):
        np.testing.assert_array_equal(dt, dj, err_msg=f"frame {k}")
        marked_by_frontend += initialised and int(dj.sum()) > 1
    assert marked_by_frontend >= 2       # initialisation and at least one later update


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


def _update_fused_both(jd, td, rounds):
    _copy_state(jd, td)
    t1 = jd.frontend.t1
    pair = (t1 - 3, t1 - 2)
    d_j = float(jd.frontend.graph.update_fused(rounds, use_inactive=True, cull_pair=pair))
    ops.reset_counts()
    tfg.reset_corr_rounds()
    with torch.no_grad():
        d_t = td.frontend.graph.update_fused(rounds, use_inactive=True, cull_pair=pair)
    t = jd.video.counter
    np.testing.assert_allclose(td.video.poses[:t].numpy(), np.asarray(jd.video.poses[:t]),
                               atol=1e-4)
    np.testing.assert_allclose(td.video.disps[:t].numpy(), np.asarray(jd.video.disps[:t]),
                               atol=1e-4)
    np.testing.assert_allclose(td.frontend.graph.weight.numpy(),
                               np.asarray(jd.frontend.graph.weight), atol=1e-4)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-4)
    return ops.counts(), dict(tfg.CORR_ROUNDS)


def test_one_update_fused_call_from_identical_state(runs):
    """Two rounds through the window cache: K4 once, K5 every round."""
    jd, td, _ = runs
    counts, rounds = _update_fused_both(jd, td, 2)
    assert rounds == {"windowed": 2, "fallback": 0}
    assert counts["corr_build_windows"] == (0, 1)
    assert counts["corr_lookup_windows"] == (0, 2)
    assert counts["corr_build"] == counts["corr_lookup"] == (0, 0)


def test_update_fused_forced_drift_takes_the_fallback(runs, monkeypatch):
    """With the drift rule failing every round, the rounds take the full
    lookup (K2 built once per call, K3 per round) and give the same result."""
    jd, td, _ = runs
    monkeypatch.setattr(tfg, "window_drift_ok",
                        lambda bases, coords, sizes: torch.zeros((), dtype=torch.bool))
    counts, rounds = _update_fused_both(jd, td, 2)
    assert rounds == {"windowed": 0, "fallback": 2}
    assert counts["corr_build_windows"] == (0, 1)
    assert counts["corr_build"] == (0, 1)
    assert counts["corr_lookup"] == (0, 2)
    assert counts["corr_lookup_windows"] == (0, 0)


def test_update_lowmem_from_identical_state(runs):
    """One backend refresh + global BA over a proximity graph of every
    keyframe, from one identical state."""
    jd, td, _ = runs
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
    assert len(tg.ii) > t and tg.ii.max() >= 8          # a global graph of two chunks
    jg.update_lowmem(steps=1)
    ops.reset_counts()
    with torch.no_grad():
        tg.update_lowmem(steps=1)
    np.testing.assert_allclose(tv.poses[:t].numpy(), np.asarray(jv.poses[:t]), atol=1e-4)
    np.testing.assert_allclose(tv.disps[:t].numpy(), np.asarray(jv.disps[:t]), atol=1e-4)
    np.testing.assert_allclose(tg.weight.numpy(), np.asarray(jg.weight), atol=1e-4)
    np.testing.assert_allclose(tv.damping[:t].numpy(), np.asarray(jv.damping[:t]), atol=1e-4)
    assert tv.dirty[:t].all()
    assert ops.counts()["corr_build"] == (0, 2)          # one K2 + K3 per chunk


def test_filter_edges_matches_jax(runs):
    """Long-range edges whose mean weight is below 1e-3 move to the bad store."""
    jd, td, _ = runs
    _copy_state(jd, td)
    jg, tg = jd.frontend.graph, td.frontend.graph
    w = np.array(jg.weight)
    w[::2] = 0.0
    jg.weight = jnp.asarray(w)
    tg.weight = torch.from_numpy(w.copy())
    n_bad = int(((np.abs(jg.ii - jg.jj) > 2) & (np.arange(len(jg.ii)) % 2 == 0)).sum())
    assert n_bad > 0
    jg.filter_edges()
    tg.filter_edges()
    for k in ("ii", "jj", "ii_bad", "jj_bad"):
        np.testing.assert_array_equal(getattr(tg, k), getattr(jg, k))
    assert len(tg.ii_bad) == n_bad and len(tg.weight) == len(tg.ii)


def test_altcorr_pyramid_matches_jax_and_k2_k3():
    rng = np.random.RandomState(0)
    E, H, W, C = 2, 16, 24, 16
    f1 = (0.3 * rng.standard_normal((E, H, W, C))).astype(np.float32)
    f2 = (0.3 * rng.standard_normal((E, H, W, C))).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1)
    coords = (grid + 3.0 * rng.standard_normal((E, H, W, 2))).astype(np.float32)
    coords[:, :2] += np.float32(30.0)

    jpyr = [jnp.asarray(f2)]
    tpyr = [torch.from_numpy(f2)]
    for _ in range(3):
        jpyr.append(jcorr.pool2x_fmap(jpyr[-1]))
        tpyr.append(tcorr.pool2x_fmap(tpyr[-1]))
    for a, b in zip(tpyr, jpyr):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    out = tcorr.altcorr_pyramid(torch.from_numpy(f1), tpyr, torch.from_numpy(coords))
    ref = jcorr.altcorr_pyramid(jnp.asarray(f1), jpyr, jnp.asarray(coords))
    assert tuple(out.shape) == ref.shape == (E, H, W, 196)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)

    levels = corr_build_plain(torch.from_numpy(f1), torch.from_numpy(f2))
    k23 = corr_lookup_plain(levels, torch.from_numpy(coords).reshape(E, H * W, 2))
    np.testing.assert_allclose(out.numpy(), k23.reshape(E, H, W, -1).numpy(),
                               atol=1e-5, rtol=1e-5)


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
    """Slice 2 brought terminate: on a map without keyframes the backend has
    nothing to refine and returns; a Droid on the card needs CUDA."""
    d = TDroid(torch_config(), device="cpu")
    d.terminate()
    assert d.video.counter == 0 and not hasattr(d, "frontend")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TDroid(torch_config())
