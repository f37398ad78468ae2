"""The port's CLI against the JAX package's: ``euroc`` mono, run in process
through both on one synthetic sequence (tests/synth_scenes.py), with
FAST_SLAM_FLAGS, one ``--weights`` .npz made from the JAX
``init_params(seed=0)``, and ``--upsample --out --gt
--reconstruction_path``; the port on the CPU (``--device cpu``).

The trajectory files agree within tests/test_torch_terminate.py's 1e-3
(the stamps exactly), the ATE JSON within 1e-4, and both export the same
keyframe files.  The port's other commands run in
tests/test_torch_cli_port.py.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.cli import main as jax_main
from droid_slam_reserch_tpu.engine.droid import init_params as jax_init_params
from droid_slam_reserch_tpu_torch.cli import main as torch_main
from synth_scenes import FAST_SLAM_FLAGS, make_euroc_sequence
from test_engine import make_config

torch.set_num_threads(1)
TOL = 1e-3


def _json_with(out, key):
    found = None
    for line in out.splitlines():
        if line.startswith("{") and key in json.loads(line):
            found = json.loads(line)
    return found


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    params = jax.tree_util.tree_map(np.asarray, jax_init_params(make_config(), seed=0))
    path = tmp_path_factory.mktemp("w") / "droid_seed0.npz"
    np.savez(path, params=np.array(params, dtype=object))
    return str(path)


def test_euroc_cli_matches_jax(tmp_path, capsys, weights):
    mav0, gt_file = make_euroc_sequence(tmp_path / "MH_01_synth", n_frames=8)
    runs = {}
    for name, main, extra in (("jax", jax_main, []), ("port", torch_main, ["--device", "cpu"])):
        out, recon = tmp_path / f"traj_{name}.txt", tmp_path / f"recon_{name}"
        main(["euroc", "--datapath", mav0, "--gt", gt_file, "--out", str(out), "--upsample",
              "--reconstruction_path", str(recon), "--weights", weights,
              *FAST_SLAM_FLAGS, *extra])
        printed = _json_with(capsys.readouterr().out, "ate")
        runs[name] = (np.loadtxt(out), printed, json.loads((tmp_path / f"traj_{name}.txt.ate.json")
                                                           .read_text()), recon)
    (traj_j, ate_j, saved_j, recon_j), (traj_t, ate_t, saved_t, recon_t) = runs["jax"], runs["port"]
    assert traj_t.shape == traj_j.shape == (8, 8) and np.isfinite(traj_t).all()
    np.testing.assert_array_equal(traj_t[:, 0], traj_j[:, 0])        # cam0 ns stamps
    np.testing.assert_allclose(traj_t[:, 1:], traj_j[:, 1:], atol=TOL)
    assert ate_t is not None and ate_t["ate"] == saved_t
    assert ate_t["ate"]["association"] == ate_j["ate"]["association"] == "timestamp"
    assert ate_t["ate"]["matches"] == ate_j["ate"]["matches"] == 8
    for k in ("rmse", "mean", "median", "std"):
        np.testing.assert_allclose(ate_t["ate"][k], ate_j["ate"][k], atol=1e-4)
    assert saved_j == ate_j["ate"]
    kf_t = sorted(os.listdir(recon_t / "keyframes_cam0"))
    assert kf_t == sorted(os.listdir(recon_j / "keyframes_cam0")) and len(kf_t) > 0
    state_t, state_j = np.load(recon_t / "reconstruction.npz"), np.load(recon_j / "reconstruction.npz")
    assert sorted(state_t.files) == sorted(state_j.files)
    np.testing.assert_array_equal(state_t["tstamps"], state_j["tstamps"])
    np.testing.assert_allclose(state_t["poses"], state_j["poses"], atol=TOL)
