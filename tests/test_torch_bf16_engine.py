"""The port's engine with compute_dtype="bfloat16" against the JAX engine's
bf16 path on the CPU.

One module-scoped run feeds the same 6 synthetic frames (tests/test_engine's
synth_frame and configuration) through the JAX Droid in bf16 and in fp32
and through the port's Droid in bf16, with the JAX ``init_params(seed=0)``
weights carried over by params_from_jax.  The JAX engine runs its CPU
``flat`` correlation with bf16 volumes; the port runs the bf16
instantiations of its windowed path (K4/K5, with the K2/K3 fallback), and
K2 on bf16 features with fp32 levels in the motion filter and the backend.
The two engines round bf16 at other places (see test_torch_bf16_models and
test_torch_bf16_kernels), so:
- keyframe counts and edge lists: identical after every frame;
- poses after every frame: 1e-2 (measured 2.6e-3 over 8 frames), and
  closer to the JAX bf16 run than the JAX fp32 run is (mean difference;
  measured 2.4e-3 against 5.5e-3 at the largest);
- from one identical state: the motion filter's features (2**-5 of their
  largest magnitude; measured 4.6e-3 of it) and its flow norm (1e-2
  relative; measured 1.6e-3), one update_fused call (windowed, and forced
  onto the fallback) and one update_lowmem step: poses 5e-4 (measured
  8.8e-5), disparities 4e-3 of their largest magnitude (measured 1.5e-3),
  weights 2e-2 (a bf16 output of the update operator; measured 5.1e-3),
  damping 2e-4 (measured 6.1e-5), the culling distance 2e-2 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.engine import Droid as JDroid
from droid_slam_reserch_tpu.engine.droid import init_params as jax_init_params
from droid_slam_reserch_tpu.engine.factor_graph import FactorGraph as JFactorGraph
from droid_slam_reserch_tpu.engine.motion_filter import _fused_track
from droid_slam_reserch_tpu_torch import ops
from droid_slam_reserch_tpu_torch.engine import Droid as TDroid
from droid_slam_reserch_tpu_torch.engine import factor_graph as tfg
from droid_slam_reserch_tpu_torch.engine.net_ops import fnet_apply, update_apply
from droid_slam_reserch_tpu_torch.models import params_from_jax
from droid_slam_reserch_tpu_torch.tools.profile_frontend import SMALL, profile
from droid_slam_reserch_tpu_torch.utils import DroidConfig as TConfig
from test_engine import INTR, make_config, synth_frame

torch.set_num_threads(1)
N_FRAMES = 6
BF = dict(compute_dtype="bfloat16")


def torch_config(**kw):
    cfg = make_config(**kw)
    return TConfig(**{k: getattr(cfg, k) for k in TConfig.__dataclass_fields__})


def _t(x, like=None):
    """A JAX array (bf16 or fp32) -> a torch tensor of like's dtype (default fp32)."""
    t = torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))
    return t if like is None else t.to(like.dtype)


def _poses(d):
    """A copy of the keyframe poses of a JAX or a port Droid."""
    t = d.video.counter
    return np.array(jnp.asarray(d.video.poses[:t]) if isinstance(d, JDroid)
                    else d.video.poses[:t])


@pytest.fixture(scope="module")
def runs():
    params = jax.tree_util.tree_map(np.asarray, jax_init_params(make_config(), seed=0))
    jd = JDroid(make_config(refresh_shards=1, **BF), params=params)
    jf = JDroid(make_config(refresh_shards=1), params=params)
    td = TDroid(torch_config(**BF), params=params_from_jax(params), device="cpu")
    assert td.video.fmaps.dtype == td.video.nets.dtype == torch.bfloat16
    assert td.video.poses.dtype == torch.float32
    rng = np.random.RandomState(0)
    frames = [synth_frame(t, rng) for t in range(N_FRAMES + 1)]
    hist = []
    for t, img in enumerate(frames[:N_FRAMES]):
        for d in (jd, jf, td):
            d.track(float(t), img, intrinsics=INTR)
        hist.append([(d.video.counter, d.frontend.graph.ii.copy(), d.frontend.graph.jj.copy(),
                      _poses(d)) for d in (jd, jf, td)])
    return jd, td, hist, frames


def test_keyframes_and_edges_every_frame_bf16(runs):
    _, _, hist, _ = runs
    for (tj, iij, jjj, _), _, (tt, iit, jjt, _) in hist:
        assert tj == tt
        np.testing.assert_array_equal(iit, iij)
        np.testing.assert_array_equal(jjt, jjj)
    assert hist[-1][0][0] == N_FRAMES and len(hist[-1][0][1]) > 0   # initialised, edges exist


def test_poses_every_frame_bf16(runs):
    _, _, hist, _ = runs
    for (_, _, _, pj), (_, _, _, pf), (_, _, _, pt) in hist:
        np.testing.assert_allclose(pt, pj, atol=1e-2)
        assert np.abs(pt - pj).mean() <= np.abs(pf - pj).mean()


def _copy_state(jd, td):
    """Load the JAX engine's video and graph state into the port's."""
    jv, tv, jg, tg = jd.video, td.video, jd.frontend.graph, td.frontend.graph
    for k in ("poses", "disps", "disps_sens", "intrinsics", "damping", "nets", "inps", "fmaps"):
        getattr(tv, k).copy_(_t(getattr(jv, k)))
    tv.counter = jv.counter
    for k in ("ii", "jj", "age", "ii_inac", "jj_inac", "ii_bad", "jj_bad"):
        setattr(tg, k, getattr(jg, k).copy())
    tg.net = _t(jg.net, tv.nets)
    for k in ("target", "weight", "target_inac", "weight_inac"):
        setattr(tg, k, _t(getattr(jg, k)))
    td.frontend.t1 = jd.frontend.t1


def _close_state(jd, td, graph_j, graph_t):
    t = jd.video.counter
    disps = np.asarray(jd.video.disps[:t])
    np.testing.assert_allclose(td.video.poses[:t].numpy(), _poses(jd), atol=5e-4)
    np.testing.assert_allclose(td.video.disps[:t].numpy(), disps,
                               atol=4e-3 * np.abs(disps).max())
    np.testing.assert_allclose(graph_t.weight.numpy(), np.asarray(graph_j.weight), atol=2e-2)
    np.testing.assert_allclose(td.video.damping[:t].numpy(), np.asarray(jd.video.damping[:t]),
                               atol=2e-4)


def _update_fused_both(jd, td, rounds):
    _copy_state(jd, td)
    t1 = jd.frontend.t1
    pair = (t1 - 3, t1 - 2)
    d_j = float(jd.frontend.graph.update_fused(rounds, use_inactive=True, cull_pair=pair))
    ops.reset_counts()
    tfg.reset_corr_rounds()
    with torch.no_grad():
        d_t = td.frontend.graph.update_fused(rounds, use_inactive=True, cull_pair=pair)
    _close_state(jd, td, jd.frontend.graph, td.frontend.graph)
    assert td.frontend.graph.net.dtype == torch.bfloat16
    np.testing.assert_allclose(d_t, d_j, rtol=2e-2)
    return ops.counts(), tfg.corr_rounds()


def test_one_update_fused_call_bf16(runs):
    """Two rounds through the bf16 window cache: K4 once, K5 every round."""
    jd, td, _, _ = runs
    counts, rounds = _update_fused_both(jd, td, 2)
    assert rounds == {"windowed": 2, "fallback": 0}
    assert counts["corr_build_windows_bf16"] == (0, 1)
    assert counts["corr_lookup_windows_bf16"] == (0, 2)
    assert all(v == (0, 0) for k, v in counts.items()
               if k.startswith("corr") and k not in ("corr_build_windows_bf16",
                                                     "corr_lookup_windows_bf16"))


def test_update_fused_forced_drift_bf16(runs, monkeypatch):
    """The fallback in bf16: K2 on bf16 features with bf16 levels, once, and
    K3 over them every round."""
    jd, td, _, _ = runs
    monkeypatch.setattr(tfg, "window_drift_ok",
                        lambda bases, coords, sizes: torch.zeros((), dtype=torch.bool))
    counts, rounds = _update_fused_both(jd, td, 2)
    assert rounds == {"windowed": 0, "fallback": 2}
    assert counts["corr_build_bf16"] == (0, 1)
    assert counts["corr_lookup_bf16"] == (0, 2)
    assert counts["corr_build"] == counts["corr_lookup"] == (0, 0)


def test_update_lowmem_bf16(runs):
    """One backend refresh + global BA from one identical state: K2 on bf16
    features with fp32 levels, fp32 K3, per chunk."""
    jd, td, _, _ = runs
    _copy_state(jd, td)
    jv, tv, cfg = jd.video, td.video, jd.cfg
    t = jv.counter
    jg = JFactorGraph(jv, jd.applies["update"], jd.params, max_factors=16 * t, dtype=jnp.bfloat16)
    tg = tfg.FactorGraph(tv, update_apply, td.net.update, max_factors=16 * t)
    for g in (jg, tg):
        g.add_proximity_factors(rad=cfg.backend_radius, nms=cfg.backend_nms,
                                thresh=cfg.backend_thresh, beta=cfg.beta)
    np.testing.assert_array_equal(tg.ii, jg.ii)
    np.testing.assert_array_equal(tg.jj, jg.jj)
    jg.update_lowmem(steps=1)
    ops.reset_counts()
    with torch.no_grad():
        tg.update_lowmem(steps=1)
    _close_state(jd, td, jg, tg)
    nc = tg.chunks[0]
    counts = ops.counts()
    assert counts["corr_build_bf16_f32"] == counts["corr_lookup"] == (0, nc)
    assert counts["corr_build_bf16"] == counts["corr_build"] == (0, 0)


def test_motion_filter_one_frame_bf16(runs):
    """From the JAX filter's state: fnet features of the next frame and the
    flow norm of the one-step check (fp32 volume from bf16 features)."""
    jd, td, _, frames = runs
    jm, tm = jd.filterx, td.filterx
    img = frames[N_FRAMES]
    imgs = jnp.asarray(img[None].astype(np.float32))
    gmap, _, _, dn = _fused_track(jd.applies["fnet"], jd.applies["cnet"], jd.applies["update"],
                                  jd.params, imgs, jm.fmap[0], jm.net, jm.inp, jnp.float32(0.0),
                                  dtype=jnp.bfloat16)
    tm.fmap = _t(jm.fmap, td.video.fmaps)
    tm.hidden = _t(jm.net, td.video.nets)
    tm.inp = _t(jm.inp, td.video.inps)
    ops.reset_counts()
    with torch.no_grad():
        tg = fnet_apply(td.net, torch.from_numpy(img[None].astype(np.float32)))
        tdn = float(tm.delta_norm(_t(gmap, tg)))
    assert tg.dtype == torch.bfloat16
    ref = np.asarray(jnp.asarray(gmap, jnp.float32))
    assert np.abs(tg.float().numpy() - ref).max() <= 2.0 ** -5 * np.abs(ref).max()
    np.testing.assert_allclose(tdn, float(dn), rtol=1e-2)
    counts = ops.counts()
    assert counts["corr_build_bf16_f32"] == counts["corr_lookup"] == (0, 1)


def test_terminate_eva_and_reconstruction_bf16(runs, tmp_path):
    """The port's terminate_eva in bf16 (backend, then the filler's bf16
    windowed rounds) returns a finite trajectory of unit quaternions; the
    reconstruction holds fp32 arrays, as the JAX package writes them."""
    _, td, _, frames = runs
    td.save_reconstruction(str(tmp_path))
    data = np.load(tmp_path / "reconstruction.npz")
    assert data["fmaps"].dtype == data["nets"].dtype == np.float32
    ops.reset_counts()
    traj = td.terminate_eva(iter([(float(t), img, INTR) for t, img in enumerate(frames)]))
    assert traj.shape == (len(frames), 7) and np.isfinite(traj).all()
    np.testing.assert_allclose(np.linalg.norm(traj[:, 3:], axis=1), 1.0, atol=1e-3)
    counts = ops.counts()
    for k in ("corr_build_bf16_f32", "corr_lookup", "corr_build_windows_bf16",
              "corr_lookup_windows_bf16", "ba_blocks"):
        assert counts[k][1] > 0 and counts[k][0] == 0, (k, counts)


def test_profile_bf16_on_the_cpu():
    """The frontend profiler in bf16: the bf16 instantiations' plain versions,
    K6-K8's among them, and none of the fp32 ones."""
    ops.reset_counts()
    res = profile(**SMALL, device="cpu", iters=1, dtype="bfloat16")
    counts = ops.counts()
    assert res["dtype"] == "bfloat16"
    assert all(res[k] >= 0 for k in ("lookup_k6_ms", "extract_k7_ms", "build_k8_ms"))
    assert max(res["k3_max_err"], res["k5_max_err"]) == 0.0   # the same plain arithmetic
    for k in ("corr_build_bf16", "corr_lookup_bf16", "corr_build_windows_bf16",
              "corr_lookup_windows_bf16", "corr_lookup_pmajor_bf16",
              "corr_extract_windows_bf16", "corr_build_windows_levels_bf16", "ba_blocks"):
        assert counts[k][0] == 0 and counts[k][1] > 0, (k, counts)
    assert all(counts[k] == (0, 0) for k in ("corr_build", "corr_lookup", "corr_build_windows",
                                             "corr_lookup_windows", "corr_lookup_pmajor",
                                             "corr_extract_windows", "corr_build_windows_levels"))
