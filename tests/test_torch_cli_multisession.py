"""The port's multisession and view commands against the JAX CLI's on the
CPU, in process, with one ``--weights`` .npz made from the JAX
``init_params(seed=0)`` and FAST_SLAM_FLAGS, on an 8-frame image directory
at 64x96 (tests/synth_scenes.py's texture):

  demo --reconstruction_path --disable_backend   session A, in each engine
  multisession-align --no_joint                  A and B (A displaced by
                                                 T_known), one loop group
  multisession-align --improve                   one group behind a shut gate
                                                 (its one keyframe after the
                                                 seeds is rejected)
  multisession                                   {the JAX CLI's A, the port
                                                 CLI's A}: each engine fuses
                                                 a file the other wrote
  multisession-evaluate                          the JAX CLI's fused map
  view --color_by_session                        both A's and the fused map

Each pair of runs writes the same files with the same keys and shapes and
prints the same JSON keys; poses, transforms, trajectories, the ATE and
the point clouds agree within 1e-3.  The joint backend that ends
``multisession-align`` is left out here: each engine's loop session gives
its own T (within 1e-3 of the other's), and the backend's 7 + 12 steps
carry that difference in its inputs to 1e-2 in its outputs.
tests/test_torch_multisession.py holds joint_backend itself against the
JAX package from one input.
"""
import contextlib
import io
import json
import os
import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu import lie as jlie
from droid_slam_reserch_tpu.cli import main as jax_main
from droid_slam_reserch_tpu.engine.droid import init_params as jax_init_params
from droid_slam_reserch_tpu_torch.cli import main as torch_main
from synth_scenes import FAST_SLAM_FLAGS, textured_image
from test_engine import make_config

torch.set_num_threads(1)
TOL = 1e-3
N_FRAMES = 8
ENGINES = {"jax": (jax_main, []), "port": (torch_main, ["--device", "cpu"])}


def _json_lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _ply(path):
    with open(path) as f:
        text = f.read()
    head, body = text.split("end_header\n")
    return head, np.loadtxt(body.splitlines(), ndmin=2)


class _Capture:
    """Collects what the commands print (both CLIs print with print())."""

    def __enter__(self):
        self.buf = io.StringIO()
        self._cm = contextlib.redirect_stdout(self.buf)
        self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        self._cm.__exit__(*exc)

    def read(self):
        out = self.buf.getvalue()
        self.buf.seek(0)
        self.buf.truncate()
        return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every command in both engines; returns the root and each run's printed JSON."""
    root = tmp_path_factory.mktemp("ms_cli")
    params = jax.tree_util.tree_map(np.asarray, jax_init_params(make_config(), seed=0))
    weights = str(root / "droid_seed0.npz")
    np.savez(weights, params=np.array(params, dtype=object))
    imgdir, imgdir6 = root / "frames", root / "frames6"
    imgdir.mkdir()
    imgdir6.mkdir()
    rng = np.random.RandomState(0)
    for t in range(N_FRAMES):
        img = textured_image(64, 96, t, rng)
        cv2.imwrite(str(imgdir / f"{t:04d}.png"), img)
        if t < 6:
            cv2.imwrite(str(imgdir6 / f"{t:04d}.png"), img)
    calib = root / "calib.txt"
    calib.write_text("60.0 60.0 48.0 32.0\n")
    flags = [*FAST_SLAM_FLAGS, "--weights", weights]
    printed = {}

    def run(name, argv, capsys_out):
        for eng, (main, extra) in ENGINES.items():
            main(argv(eng) + flags + extra)
            printed[name, eng] = _json_lines(capsys_out())

    # stage 1 in both engines; B is the JAX CLI's A displaced by T_known
    capture = _Capture()
    with capture:
        run("demo", lambda e: ["demo", "--imagedir", str(imgdir), "--calib", str(calib),
                               "--target_area", "6144", "--disable_backend",
                               "--reconstruction_path", str(root / f"a_{e}")], capture.read)
        A = dict(np.load(root / "a_jax" / "reconstruction.npz"))
        T_known = np.asarray(jlie.se3_exp(jnp.array([0.5, -0.2, 0.1, 0.05, -0.1, 0.08])),
                             np.float32)
        B = dict(A, poses=np.asarray(jlie.se3_mul(jnp.asarray(T_known)[None],
                                                  jnp.asarray(A["poses"]))))
        (root / "b").mkdir()
        np.savez_compressed(root / "b" / "reconstruction.npz", **B)

        group = {"imagedir": str(imgdir), "calib": str(calib)}
        spec = root / "spec.json"
        spec.write_text(json.dumps({"groups": [dict(group, seed_idx=[0, 1, 2, 3, 4],
                                                    old_idx=[5, 6, 7], frame_idx=[5, 6, 7])]}))
        run("align", lambda e: ["multisession-align", "--first", str(root / "a_jax/reconstruction.npz"),
                                "--second", str(root / "b/reconstruction.npz"), "--spec", str(spec),
                                "--out", str(root / f"align_{e}"), "--no_joint"], capture.read)
        # the shut gate rejects the one keyframe after the 5 seeds
        ispec = root / "improve.json"
        ispec.write_text(json.dumps({"groups": [{"imagedir": str(imgdir6), "calib": str(calib),
                                                 "seed_idx": [0, 1, 2, 3, 4],
                                                 "frame_idx": [0, 1, 2, 3, 4, 5]}]}))
        run("improve", lambda e: ["multisession-align", "--improve", "--first",
                                  str(root / "a_jax/reconstruction.npz"), "--spec", str(ispec),
                                  "--out", str(root / f"improve_{e}"), "--bad_limit", "0",
                                  "--quality_mean_thresh", "1e9", "--quality_min_thresh", "1e9"],
            capture.read)

        sessions = root / "sessions"
        for name, eng in (("a", "jax"), ("b", "port")):
            (sessions / name).mkdir(parents=True)
            shutil.copy(root / f"a_{eng}" / "reconstruction.npz", sessions / name)
        run("fuse", lambda e: ["multisession", "--sessions", str(sessions), "--subsample", "2",
                               "--out", str(root / f"fused_{e}")], capture.read)

        gt = root / "gt.txt"
        np.savetxt(gt, np.array([[float(t), 0.05 * t, 0, 0, 0, 0, 0, 1] for t in range(N_FRAMES)]))
        seq = dict(group, gt=str(gt))
        espec = root / "eval.json"
        espec.write_text(json.dumps({"sequences": [dict(seq, start=0, stop=4),
                                                   dict(seq, start=4, stop=8)]}))
        run("evaluate", lambda e: ["multisession-evaluate", "--fused",
                                   str(root / "fused_jax/fused.npz"), "--spec", str(espec),
                                   "--out", str(root / f"trajs_{e}")], capture.read)

        recons = [str(root / "a_jax/reconstruction.npz"), str(root / "a_port/reconstruction.npz"),
                  str(root / "fused_jax/fused.npz")]
        for eng, (main, extra) in ENGINES.items():
            main(["view", "--reconstruction", *recons, "--color_by_session",
                  "--out", str(root / f"cloud_{eng}.ply"), *extra])
            printed["view", eng] = capture.read()
    return root, printed, T_known


def _same_npz(a, b, exact=("tstamps", "tstamp", "images")):
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].shape == zb[k].shape and za[k].dtype == zb[k].dtype, k
        if k in exact:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    return za, zb


def test_demo_sessions_match(runs):
    root, printed, _ = runs
    zt, zj = _same_npz(root / "a_port/reconstruction.npz", root / "a_jax/reconstruction.npz")
    assert len(zj["poses"]) == N_FRAMES
    np.testing.assert_allclose(zt["poses"], zj["poses"], atol=TOL)
    assert sorted(os.listdir(root / "a_port")) == sorted(os.listdir(root / "a_jax"))


def test_align_matches_jax(runs):
    root, printed, T_known = runs
    pj, pt = printed["align", "jax"], printed["align", "port"]
    assert [sorted(d) for d in pt] == [sorted(d) for d in pj] == [["T", "rows"]]
    assert pt[0]["rows"] == pj[0]["rows"] == 3
    np.testing.assert_allclose(pt[0]["T"], pj[0]["T"], atol=TOL)
    assert os.listdir(root / "align_port") == os.listdir(root / "align_jax") == ["aligned.npz"]
    zt, zj = _same_npz(root / "align_port/aligned.npz", root / "align_jax/aligned.npz")
    for k in zj.files:
        np.testing.assert_allclose(zt[k], zj[k], atol=TOL, err_msg=k)
    # the recovered transform is T_known, loosely: random weights give the
    # loop replay its own estimates of frames 5-7 (the JAX package's
    # tests/test_cli_multisession.py holds the same)
    np.testing.assert_allclose(zt["T"][:3], T_known[:3], atol=1.0)
    assert abs(float(np.dot(zt["T"][3:], T_known[3:]))) > 0.9


def test_improve_rejection_matches_jax(runs):
    root, printed, _ = runs
    pj, pt = printed["improve", "jax"], printed["improve", "port"]
    assert pt == pj
    assert pt[0]["recovered"] is False
    assert pt[0]["report"] == [{"group": 0, "bad": 1, "accepted": False}]
    assert os.listdir(root / "improve_port") == os.listdir(root / "improve_jax") == []


def test_fuse_across_engines_matches_jax(runs):
    """Each engine fuses the JAX CLI's session with the port CLI's."""
    root, printed, _ = runs
    assert printed["fuse", "port"] == printed["fuse", "jax"] == []
    zt, zj = _same_npz(root / "fused_port/fused.npz", root / "fused_jax/fused.npz")
    assert len(zj["poses"]) == N_FRAMES           # 4 + 4 subsampled keyframes
    np.testing.assert_allclose(zt["poses"], zj["poses"], atol=TOL)
    np.testing.assert_allclose(zt["disps"], zj["disps"], atol=TOL)


def test_evaluate_matches_jax(runs):
    root, printed, _ = runs
    pj, pt = printed["evaluate", "jax"], printed["evaluate", "port"]
    assert [sorted(d) for d in pt] == [sorted(d) for d in pj] == [["ate", "sequences"]]
    assert pt[0]["sequences"] == pj[0]["sequences"] == 2
    assert sorted(pt[0]["ate"]) == sorted(pj[0]["ate"])
    assert pt[0]["ate"]["matches"] == pj[0]["ate"]["matches"]
    for k in ("rmse", "mean", "median", "std"):
        np.testing.assert_allclose(pt[0]["ate"][k], pj[0]["ate"][k], atol=1e-4)
    assert sorted(os.listdir(root / "trajs_port")) == sorted(os.listdir(root / "trajs_jax"))
    for i in range(2):
        tt, tj = (np.load(root / f"trajs_{e}/traj_{i}.npy") for e in ("port", "jax"))
        assert tt.shape == tj.shape == (N_FRAMES, 7)
        np.testing.assert_allclose(tt, tj, atol=TOL)


def test_view_matches_jax(runs):
    root, printed, _ = runs
    assert printed["view", "port"].splitlines() == [
        ln.replace("cloud_jax", "cloud_port") for ln in printed["view", "jax"].splitlines()]
    head_t, pts_t = _ply(root / "cloud_port.ply")
    head_j, pts_j = _ply(root / "cloud_jax.ply")
    assert head_t == head_j and "property uchar red" in head_t
    assert pts_t.shape == pts_j.shape and len(pts_t) > 0
    np.testing.assert_allclose(pts_t[:, :3], pts_j[:, :3], atol=TOL)
    np.testing.assert_array_equal(pts_t[:, 3:], pts_j[:, 3:])



def test_align_with_vis_path_leaves_no_viewer(runs, tmp_path):
    """`multisession-align --vis_path`: the loop replay tracks without a
    live viewer, since nothing would stop it (its thread would hold the
    replay's Video); only the joint backend's SDroid, which terminate
    stops, streams one (Droid's viewer: tests/test_torch_viz.py)."""
    import threading

    root, printed, _ = runs
    live = tmp_path / "live.ply"
    with _Capture() as capture:
        torch_main(["multisession-align", "--first", str(root / "a_jax/reconstruction.npz"),
                    "--second", str(root / "b/reconstruction.npz"), "--spec", str(root / "spec.json"),
                    "--out", str(tmp_path / "align"), "--no_joint", "--vis_path", str(live),
                    *FAST_SLAM_FLAGS, "--weights", str(root / "droid_seed0.npz"), "--device", "cpu"])
    assert _json_lines(capture.read()) == printed["align", "port"]
    assert not [t for t in threading.enumerate() if t.name == "LiveViewer"]
    assert not live.exists()
