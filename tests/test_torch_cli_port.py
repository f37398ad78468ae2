"""The port's CLI commands at a tiny size on the CPU (``--device cpu``):
``euroc --stereo``, ``tum``, ``eth3d --depth --upsample``, ``tartanair``,
``demo`` and the refusals.  Each runs in process on a synthetic dataset
(tests/synth_scenes.py) with FAST_SLAM_FLAGS and gives finite outputs of
the right shapes, and the ATE JSON where a ground truth is given.  Their
readers and engines are held against the JAX package by
tests/test_torch_data.py and tests/test_torch_{engine,stereo,rgbd}.py, and
``euroc`` mono against the JAX CLI by tests/test_torch_cli.py.
"""
import json
import os

import cv2
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu_torch.cli import _config_from_args, build_parser, main
from droid_slam_reserch_tpu_torch.utils import TUM_CONFIG
from synth_scenes import (FAST_SLAM_FLAGS, make_eth3d_sequence, make_euroc_sequence,
                          make_tartanair_scene, make_tum_sequence, textured_image)

torch.set_num_threads(1)
CPU = ["--device", "cpu"]


def _json_with(out, key):
    found = None
    for line in out.splitlines():
        if line.startswith("{") and key in json.loads(line):
            found = json.loads(line)
    return found


def test_euroc_stereo(tmp_path, capsys):
    mav0, gt_file = make_euroc_sequence(tmp_path / "MH_st", n_frames=8, stereo=True)
    out = tmp_path / "traj.txt"
    droid = main(["euroc", "--datapath", mav0, "--gt", gt_file, "--stereo", "--out", str(out),
                  *FAST_SLAM_FLAGS, *CPU])
    assert droid.cfg.stereo and droid.video.fmaps.shape[1] == 2
    traj = np.loadtxt(out)
    assert traj.shape == (8, 8) and np.isfinite(traj).all() and traj[0, 0] > 1e18
    res = _json_with(capsys.readouterr().out, "ate")
    assert res is not None and np.isfinite(res["ate"]["rmse"]) and res["ate"]["matches"] >= 3


def test_tum(tmp_path, capsys):
    seq, gt_file = make_tum_sequence(tmp_path / "fr1", n_frames=12)
    droid = main(["tum", "--datapath", str(seq), "--gt", gt_file, *FAST_SLAM_FLAGS, *CPU])
    out = capsys.readouterr().out
    assert "tracked 6 frames" in out                    # stride 2
    assert droid.video.counter >= 5 and droid.cfg.image_size == (64, 96)
    res = _json_with(out, "ate")
    assert res is not None and np.isfinite(res["ate"]["rmse"])


def test_eth3d_depth_upsample(tmp_path, capsys):
    seq = make_eth3d_sequence(tmp_path / "eth3d", n_frames=8, with_depth=True)
    droid = main(["eth3d", "--datapath", str(seq), "--depth", "--upsample",
                  *FAST_SLAM_FLAGS, *CPU])
    out = capsys.readouterr().out
    assert "tracked 8 frames" in out
    v = droid.video
    t = v.counter
    assert droid.cfg.rgbd and bool((v.disps_sens[:t] > 0).all())
    up = v.disps_up[:t]
    assert up.shape == (t,) + droid.cfg.image_size and bool(torch.isfinite(up).all())
    assert bool((up.abs().flatten(1).amax(1) > 0).all())
    res = _json_with(out, "ate") or _json_with(out, "ate_error")
    assert res is not None
    if "ate" in res:
        assert np.isfinite(res["ate"]["rmse"])


def test_tartanair(tmp_path, capsys):
    scene = make_tartanair_scene(str(tmp_path / "P000"), n_frames=8)
    droid = main(["tartanair", "--datapath", scene, "--gt",
                  os.path.join(scene, "pose_left.txt"), *FAST_SLAM_FLAGS, *CPU])
    res = _json_with(capsys.readouterr().out, "ate_score")
    assert res is not None and np.isfinite(res["ate_score"])
    assert droid.video.counter >= 5


def test_demo(tmp_path, capsys):
    os.makedirs(tmp_path / "imgs")
    rng = np.random.RandomState(0)
    for t in range(8):
        cv2.imwrite(str(tmp_path / "imgs" / f"{t:04d}.png"), textured_image(120, 160, t, rng))
    (tmp_path / "calib.txt").write_text("100.0 100.0 80.0 60.0\n")
    recon = tmp_path / "recon"
    droid = main(["demo", "--imagedir", str(tmp_path / "imgs"), "--calib",
                  str(tmp_path / "calib.txt"), "--target_area", str(64 * 96),
                  "--reconstruction_path", str(recon), *FAST_SLAM_FLAGS, *CPU])
    out = capsys.readouterr().out
    t = droid.video.counter
    assert f"tracked {t} keyframes" in out and t >= 5
    state = np.load(recon / "reconstruction.npz")
    assert state["poses"].shape == (t, 7) and np.isfinite(state["poses"]).all()
    assert state["images"].shape[1:] == droid.cfg.image_size + (3,)


def test_commands_and_refusals():
    """The ten commands of the JAX CLI, the card as the default device
    (``train`` included), --vis_path reaching the engine's configuration,
    and an unknown command refused."""
    sub = next(a for a in build_parser()._actions if a.dest == "cmd")
    assert sorted(sub.choices) == ["demo", "eth3d", "euroc", "multisession", "multisession-align",
                                   "multisession-evaluate", "tartanair", "train", "tum", "view"]
    args = build_parser().parse_args(["tum", "--datapath", "x"])
    assert args.device == "cuda"
    assert build_parser().parse_args(["view", "--reconstruction", "a.npz"]).device == "cuda"
    args = build_parser().parse_args(["tum", "--datapath", "x", "--vis_path", "cloud.ply"])
    assert _config_from_args(TUM_CONFIG, args).vis_path == "cloud.ply"
    args = build_parser().parse_args(["train", "--datapath", "x"])
    assert (args.device, args.iters, args.n_frames, args.image_size) == ("cuda", 15, 7, [384, 512])
    with pytest.raises(SystemExit):
        build_parser().parse_args(["calibrate", "--datapath", "x"])
