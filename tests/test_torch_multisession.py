"""The port's multisession stages against the JAX package's on the CPU.

Map A is one module-scoped JAX track of tests/test_engine's 8 frames at its
configuration (the JAX ``init_params(seed=0)`` weights, carried over to the
port by params_from_jax); map B is A displaced by a known SE3 T_known.  The
loop streams replay the same frames.  Each stage runs once per engine in a
module-scoped fixture and the tests read its results:

- parse_group_sequence equal; compute_filtered_mean, estimate_alignment
  and transform_poses within 1e-5; Video.load_state_dict exactly;
- probe_quality's summed confidence within a relative 1e-3 (and the edges'
  new hidden state within 1e-4);
- the gated SessionFrontend's badT and keyframe counts equal at
  thresholds far from the values (1e9 rejects every keyframe, -1 none);
- the poses of run_loop_session (the seeded slots after the initialisation
  included), align_pair, joint_backend and fuse_maps, and the trajectories
  of evaluate_fused_map, within 1e-3, as tracking is held; the ATE within
  1e-4;
- improve_adjust through a rejection, then stitching reverse-first: the
  reports equal, the recovered state within 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu import lie as jlie
from droid_slam_reserch_tpu import multisession as jms
from droid_slam_reserch_tpu.engine import Droid as JDroid
from droid_slam_reserch_tpu.engine.droid import init_params as jax_init_params
from droid_slam_reserch_tpu.engine.video import Video as JVideo
from droid_slam_reserch_tpu.multisession import pipeline as jpipe
from droid_slam_reserch_tpu_torch import multisession as tms
from droid_slam_reserch_tpu_torch.engine import Droid as TDroid
from droid_slam_reserch_tpu_torch.engine.video import Video as TVideo
from droid_slam_reserch_tpu_torch.models import params_from_jax
from droid_slam_reserch_tpu_torch.multisession import pipeline as tpipe
from test_engine import INTR, make_config, synth_frame
from test_torch_engine import _copy_state, torch_config

torch.set_num_threads(1)
TOL = 1e-3
N_FRAMES = 8
SEEDS = np.arange(5)                     # map A's keyframes seeding a loop session
T_XI = [0.5, -0.2, 0.1, 0.05, -0.1, 0.08]
GATE_OFF = dict(quality_mean_thresh=-1.0, quality_min_thresh=-1.0)
GATE_SHUT = dict(quality_mean_thresh=1e9, quality_min_thresh=1e9)
# one edge and one window bucket for every call: fewer JAX programs to compile
BUCKETS = dict(edge_bucket=32, window_bucket=16)


def _frames():
    rng = np.random.RandomState(0)
    return [synth_frame(t, rng) for t in range(N_FRAMES)]


def _factory(frames, order):
    return lambda: iter([(float(t), frames[t], INTR) for t in order])


def _jax_config(**kw):
    # one device for the JAX backend refresh (the port has no sharded refresh)
    return make_config(refresh_shards=1, **BUCKETS, **kw)


def _torch_config(**kw):
    return torch_config(**BUCKETS, **kw)


class Recorder:
    """Wraps a pipeline module's run_loop_session and keeps every session
    it returns, with its ``good`` flag."""

    def __init__(self, module):
        self.module, self.orig, self.runs = module, module.run_loop_session, []

    def __enter__(self):
        def run(*args, **kw):
            droid = self.orig(*args, **kw)
            self.runs.append((kw.get("good", True), droid))
            return droid
        self.module.run_loop_session = run
        return self

    def __exit__(self, *exc):
        self.module.run_loop_session = self.orig


@pytest.fixture(scope="module")
def maps():
    """(JAX params, port params, the tracked JAX Droid, map A, map B, T_known, frames)."""
    params = jax.tree_util.tree_map(np.asarray, jax_init_params(make_config(), seed=0))
    frames = _frames()
    jd = JDroid(_jax_config(), params=params)
    for t, img in enumerate(frames):
        jd.track(float(t), img, intrinsics=INTR)
    A = jd.video.state_dict()
    T_known = np.asarray(jlie.se3_exp(jnp.array(T_XI)), np.float32)
    B = dict(A, poses=np.asarray(jlie.se3_mul(jnp.asarray(T_known)[None], jnp.asarray(A["poses"]))))
    assert len(A["poses"]) == N_FRAMES
    return params, params_from_jax(params), jd, A, B, T_known, frames


@pytest.fixture(scope="module")
def aligned(maps):
    """align_pair in both engines (one loop group: A's first 5 keyframes
    seed the session, B's keyframes 5-7 are matched by its tail), with the
    loop sessions they ran."""
    params, tparams, _, A, B, _, frames = maps
    out = {}
    runs = [(SEEDS, np.arange(5, 8), _factory(frames, range(N_FRAMES)))]
    with Recorder(jpipe) as rec:
        out["jax"] = jms.align_pair(_jax_config(), params, A, B, runs) + (rec.runs[0][1],)
    with Recorder(tpipe) as rec:
        out["port"] = tms.align_pair(_torch_config(), tparams, A, B, runs, device="cpu") + (
            rec.runs[0][1],)
    return out


@pytest.fixture(scope="module")
def improved(maps):
    """improve_adjust in both engines: one group behind a shut gate (every
    keyframe rejected, so the group is), then a reverse and a forward group
    with the gate off, stitched; with the sessions each ran."""
    params, tparams, _, A, _, _, frames = maps
    groups = {
        "shut": [dict(seed_idx=SEEDS, frame_idx=list(range(6)), name="fwd",
                      stream_factory=_factory(frames, range(N_FRAMES)))],
        "off": [dict(seed_idx=SEEDS, frame_idx=[5, 4, 3, 2, 1, 0], name="rev",
                     stream_factory=_factory(frames, range(5, -1, -1))),
                dict(seed_idx=SEEDS, frame_idx=list(range(6)), name="fwd",
                     stream_factory=_factory(frames, range(6)))],
    }
    gates = {"shut": GATE_SHUT, "off": GATE_OFF}
    out = {}
    for case in ("shut", "off"):
        with Recorder(jpipe) as rj:
            j = jpipe.improve_adjust(_jax_config(**gates[case]), params, A, groups[case],
                                     bad_limit=2, probe_frames=N_FRAMES)
        with Recorder(tpipe) as rt:
            t = tpipe.improve_adjust(_torch_config(**gates[case]), tparams, A, groups[case],
                                     bad_limit=2, probe_frames=N_FRAMES, device="cpu")
        out[case] = (j, t, rj.runs, rt.runs)
    return out


def test_parse_group_sequence_equal(tmp_path):
    from droid_slam_reserch_tpu.multisession import parse_group_sequence as jparse
    from droid_slam_reserch_tpu_torch.multisession import parse_group_sequence as tparse

    p = tmp_path / "GroupSequence.txt"
    p.write_text("0\nFirst Images Series: 1 2 3 4\nSecond Images Series: 10 11 12 [Order] \n"
                 "Third Images Series: 20 21 22 [ReverseOrder] \n1\nFirst Images Series: 5 6 7\n")
    assert tparse(str(p)) == jparse(str(p))
    assert tparse(str(p))[0][2] == [22, 21, 20]


def test_alignment_functions_match_jax(maps):
    _, _, _, A, B, T_known, _ = maps
    rng = np.random.RandomState(0)
    rows = 1.0 + 0.01 * rng.randn(50, 7)
    rows[3] = 100.0
    np.testing.assert_allclose(tms.compute_filtered_mean(rows), jms.compute_filtered_mean(rows),
                               atol=1e-12)
    np.testing.assert_array_equal(tms.remove_outlier_rows(rows), jms.remove_outlier_rows(rows))
    np.testing.assert_allclose(tms.normalize_transform(rows[0]), jms.normalize_transform(rows[0]))

    T_t, rows_t = tms.estimate_alignment(B["poses"], A["poses"])
    T_j, rows_j = jms.estimate_alignment(B["poses"], A["poses"])
    assert T_t.dtype == T_j.dtype == np.float32
    np.testing.assert_allclose(rows_t, rows_j, atol=1e-5)
    np.testing.assert_allclose(T_t, T_j, atol=1e-5)
    np.testing.assert_allclose(T_t, T_known, atol=1e-4)      # exact correspondences
    for inverse in (True, False):
        np.testing.assert_allclose(tms.transform_poses(T_t, B["poses"], inverse),
                                   jms.transform_poses(T_t, B["poses"], inverse), atol=1e-5)
    np.testing.assert_allclose(tms.transform_poses(T_t, B["poses"]), A["poses"], atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_state_dict_round_trip(maps, dtype):
    """A saved session written at an offset into both engines' buffers:
    state_dict gives back the JAX Video's, bit for bit (the fp32 map
    itself; in bf16 the features rounded to nearest even)."""
    _, _, _, A, _, _, _ = maps
    sub = {k: v for k, v in A.items() if k != "disps_sens"}   # disps_sens is optional
    jv = JVideo(_jax_config(compute_dtype=dtype))
    tv = TVideo(_torch_config(compute_dtype=dtype), device="cpu")
    for v in (jv, tv):
        v.counter = 2
        v.load_state_dict(A, offset=3)
        v.load_state_dict(sub, offset=3 + N_FRAMES)
    assert tv.counter == jv.counter == 3 + 2 * N_FRAMES
    sj, st = jv.state_dict(), tv.state_dict()
    assert sorted(st) == sorted(sj)
    for k in sj:
        assert st[k].dtype == sj[k].dtype, k
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    if dtype == "float32":
        for k in A:
            np.testing.assert_array_equal(st[k][3:3 + N_FRAMES], A[k], err_msg=k)
    else:
        assert not np.array_equal(st["fmaps"][3:3 + N_FRAMES], A["fmaps"])


def test_probe_quality_matches_jax(maps):
    """One update-operator step over the JAX frontend's edges, from the same
    state: the summed confidence per edge and the new hidden states."""
    _, tparams, jd, _, _, _, _ = maps
    td = TDroid(_torch_config(), params=tparams, device="cpu")
    jg = jd.frontend.graph
    net_before = jg.net
    _copy_state(jd, td)
    try:
        s_j = jg.probe_quality()
        net_j = np.asarray(jg.net)
    finally:
        jg.net = net_before
    with torch.no_grad():
        s_t = td.frontend.graph.probe_quality()
    assert s_t.shape == s_j.shape == (len(jg.ii),) and len(s_j) > 0
    np.testing.assert_allclose(s_t, s_j, rtol=1e-3)
    np.testing.assert_allclose(td.frontend.graph.net.numpy(), net_j, atol=1e-4)
    # the probe ran no BA: the poses did not move
    np.testing.assert_array_equal(td.video.poses.numpy(), np.asarray(jd.video.poses))


def test_gated_frontend_decisions_match_jax(improved):
    """The probes of improve_adjust: behind the shut gate every keyframe
    after the initialisation is rejected and its stamp kept in badT; with
    the gate off none is.  Keyframe counts and badT equal."""
    for case in ("shut", "off"):
        _, _, runs_j, runs_t = improved[case]
        probes_j = [d for good, d in runs_j if not good]
        probes_t = [d for good, d in runs_t if not good]
        assert len(probes_t) == len(probes_j) == (1 if case == "shut" else 2)
        for dj, dt in zip(probes_j, probes_t):
            assert dt.frontend.badT == dj.frontend.badT
            assert dt.video.counter == dj.video.counter
            assert dt.frontend.t1 == dj.frontend.t1
        if case == "shut":
            assert len(probes_t[0].frontend.badT) == N_FRAMES - len(SEEDS)
        else:
            assert all(d.frontend.badT == [] for d in probes_t)


def test_loop_session_matches_jax(aligned):
    """The loop session of align_pair: its seeded slots after the
    initialisation and every keyframe's pose."""
    dj, dt = aligned["jax"][3], aligned["port"][3]
    t = dj.video.counter
    assert dt.video.counter == t == N_FRAMES
    np.testing.assert_allclose(dt.video.poses[:t].numpy(), np.asarray(dj.video.poses[:t]),
                               atol=TOL)
    np.testing.assert_array_equal(dt.video.tstamp[:t], dj.video.tstamp[:t])


def test_align_pair_matches_jax(maps, aligned):
    T_j, poses_j, rows_j, _ = aligned["jax"]
    T_t, poses_t, rows_t, _ = aligned["port"]
    assert T_t.dtype == np.float32 and rows_t.shape == rows_j.shape == (3, 7)
    np.testing.assert_allclose(rows_t, rows_j, atol=TOL)
    np.testing.assert_allclose(T_t, T_j, atol=TOL)
    np.testing.assert_allclose(poses_t, poses_j, atol=TOL)


def test_joint_backend_matches_jax(maps, aligned):
    params, tparams, _, A, B, _, _ = maps
    second = dict(B, poses=aligned["jax"][1])
    ref_j = jms.joint_backend(_jax_config(), params, [A, second])
    ref_t = tms.joint_backend(_torch_config(), tparams, [A, second], device="cpu")
    assert [r.shape for r in ref_t] == [r.shape for r in ref_j] == [(N_FRAMES, 7)] * 2
    for rt, rj in zip(ref_t, ref_j):
        np.testing.assert_allclose(rt, rj, atol=TOL)


def test_fuse_and_evaluate_match_jax(maps, aligned):
    """fuse_maps over A and the aligned B (subsample 2), then
    evaluate_fused_map on the JAX fused map, one sequence per session."""
    params, tparams, _, A, B, _, frames = maps
    states = [A, dict(B, poses=aligned["jax"][1])]
    fused_j = jms.fuse_maps(_jax_config(), params, states, subsample=2)
    fused_t = tms.fuse_maps(_torch_config(), tparams, states, subsample=2, device="cpu")
    assert sorted(fused_t) == sorted(fused_j)
    for k in fused_j:
        assert fused_t[k].shape == fused_j[k].shape, k
    assert len(fused_t["poses"]) == N_FRAMES
    np.testing.assert_allclose(fused_t["poses"], fused_j["poses"], atol=TOL)
    np.testing.assert_array_equal(fused_t["tstamps"], fused_j["tstamps"])

    gt = np.array([[float(t), 0.05 * t, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0] for t in range(N_FRAMES)])
    slices = [(0, 4), (4, 8)]
    streams = [_factory(frames, range(N_FRAMES))] * 2
    trajs_j, res_j = jms.evaluate_fused_map(_jax_config(), params, fused_j, slices, streams,
                                            gts=[gt, gt])
    trajs_t, res_t = tms.evaluate_fused_map(_torch_config(), tparams, fused_j, slices, streams,
                                            gts=[gt, gt], device="cpu")
    assert len(trajs_t) == len(trajs_j) == 2
    for a, b in zip(trajs_t, trajs_j):
        assert a.shape == b.shape == (N_FRAMES, 7)
        np.testing.assert_allclose(a, b, atol=TOL)
    assert sorted(res_t) == sorted(res_j) and res_t["matches"] == res_j["matches"]
    for k in ("rmse", "mean", "median", "std"):
        np.testing.assert_allclose(res_t[k], res_j[k], atol=1e-4)


def test_improve_adjust_matches_jax(improved):
    (state_j, rep_j), (state_t, rep_t), _, _ = improved["shut"]
    assert state_j is None and state_t is None
    assert rep_t == rep_j and rep_t[0]["accepted"] is False

    (state_j, rep_j), (state_t, rep_t), runs_j, runs_t = improved["off"]
    assert rep_t == rep_j and [r["forward"] for r in rep_t] == [False, True]
    assert sorted(state_t) == sorted(state_j)
    for k in state_j:
        assert state_t[k].shape == state_j[k].shape, k
    np.testing.assert_array_equal(state_t["tstamp"], state_j["tstamp"])
    np.testing.assert_array_equal(state_t["images"], state_j["images"])
    for k in ("poses", "disps", "intrinsics"):
        np.testing.assert_allclose(state_t[k], state_j[k], atol=TOL, err_msg=k)
    # the accepted groups' replays ran ungated
    assert [good for good, _ in runs_t] == [good for good, _ in runs_j] == [False, True] * 2
