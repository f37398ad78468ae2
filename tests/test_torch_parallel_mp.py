"""The port's multi-process paths on two CPU ranks joined over gloo
(tests/torch_mp_worker.py spawned twice per group; two groups in all).

The step group (64x64, 3 frames, one iteration, a global batch of 2):
- the data-parallel step (one item a rank) equals the single-process step
  on the whole batch: loss within 1e-6 relative, the clipped gradient (the
  first Adam moment) within 1e-5 relative L2 and the parameters within 1e-6,
  over every parameter but the fnet's conv biases in front of an instance
  norm, whose gradient is zero in exact arithmetic (rounding noise under
  1e-9, held absolutely; tests/test_torch_train_step.py);
- both ranks hold identical parameters after the dp and the fsdp step;
- the fsdp step (each parameter and Adam moment split in 2 where an axis
  divides) equals the dp step at the same tolerances and the single-process
  step within 1e-6, with cfg.clip at 0.1, under this gradient's global
  norm (about 0.32: the update operator's heads zero gradient entries above
  0.01, which bounds it), so the clip to the global norm binds and a
  per-slice norm would scale each slice apart;
- dist_ba_solve over the group (one shard a rank) equals the in-process
  solve with both shards, in both exchanges, bit for bit.
The cli group: ``cli train`` on 2 ranks takes 2 steps, and only rank 0
writes checkpoints and the log.
"""
import os
import socket
import subprocess
import sys

import cv2
import numpy as np
import pytest

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mp_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(mode, out, *extra):
    """Both ranks of a gloo group; returns their outputs after both exit."""
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if not k.startswith("DROID_")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, WORKER, mode, port, str(r), str(out), *extra],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o[-4000:]}"
    return outs


@pytest.fixture(scope="module")
def step_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp_step")
    _spawn("step", out)
    return [dict(np.load(out / f"step_{r}.npz")) for r in (0, 1)]


def _keys(res):
    return sorted(k[len("ref_p/"):] for k in res if k.startswith("ref_p/"))


ZERO_GRAD_PREFIX = "fnet."          # fnet conv biases feed an instance norm


def _compare(res, a, b, rel_mu, abs_p):
    keys = _keys(res)
    zero = [k for k in keys if k.startswith(ZERO_GRAD_PREFIX) and k.endswith(".bias")]
    rest = [k for k in keys if k not in zero]
    num = sum(float(((res[f"{a}_mu/{k}"] - res[f"{b}_mu/{k}"]) ** 2).sum()) for k in rest)
    den = sum(float((res[f"{b}_mu/{k}"] ** 2).sum()) for k in rest)
    assert np.sqrt(num / den) <= rel_mu, (a, b, np.sqrt(num / den))
    for k in rest:
        np.testing.assert_allclose(res[f"{a}_p/{k}"], res[f"{b}_p/{k}"], atol=abs_p, err_msg=k)
    for k in zero:
        np.testing.assert_allclose(res[f"{a}_mu/{k}"], res[f"{b}_mu/{k}"], atol=1e-9, err_msg=k)


def test_dp_step_equals_single_process_step(step_results):
    res = step_results[0]
    np.testing.assert_allclose(res["dp_loss"], res["ref_loss"], rtol=1e-6)
    _compare(res, "dp", "ref", 1e-5, 1e-6)


def test_ranks_hold_identical_params(step_results):
    r0, r1 = step_results
    for name in ("dp", "fsdp"):
        for k in _keys(r0):
            assert np.array_equal(r0[f"{name}_p/{k}"], r1[f"{name}_p/{k}"]), (name, k)
            assert np.array_equal(r0[f"{name}_mu/{k}"], r1[f"{name}_mu/{k}"]), (name, k)
    assert r0["dp_loss"] == r1["dp_loss"]


def test_fsdp_step_equals_dp_under_the_global_clip(step_results):
    res = step_results[0]
    assert res["grad_norm"] > 0.1                        # the clip (cfg.clip = 0.1) binds
    assert res["fsdp_sliced"] > 50 and res["dp_sliced"] == 0
    _compare(res, "fsdp", "dp", 1e-5, 1e-6)
    _compare(res, "fsdp", "ref", 1e-6, 1e-6)


def test_group_dist_ba_equals_in_process(step_results):
    for res in step_results:
        assert res["ba_moved"] > 1e-3
        for exchange in ("gather_root", "dense_psum"):
            for q in ("poses", "disps"):
                np.testing.assert_array_equal(res[f"ba_group_{exchange}_{q}"],
                                              res[f"ba_local_{exchange}_{q}"])


def test_cli_train_on_two_ranks(tmp_path):
    """cli train with the DROID_* variables on 2 gloo ranks: 2 steps; rank 0
    alone writes the checkpoints and the log."""
    scene = tmp_path / "tartan" / "env" / "env" / "Easy" / "P001"
    (scene / "image_left").mkdir(parents=True)
    (scene / "depth_left").mkdir(parents=True)
    rng = np.random.RandomState(0)
    H, W, T = 480, 640, 10
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    for t in range(T):
        img = np.clip(127 + 90 * np.sin(0.05 * (xs + 25 * t)) * np.cos(0.04 * ys)
                      + 10 * rng.standard_normal((H, W)), 0, 255).astype(np.uint8)
        cv2.imwrite(str(scene / "image_left" / f"{t:06d}.png"), np.repeat(img[..., None], 3, -1))
        depth = 2.0 + 0.2 * np.sin(0.01 * xs) * np.cos(0.01 * ys)
        np.save(scene / "depth_left" / f"{t:06d}.npy", depth.astype(np.float32))
    np.savetxt(scene / "pose_left.txt",
               np.asarray([[0.0, 0.1 * t, 0.0, 0.0, 0.0, 0.0, 1.0] for t in range(T)]))
    out = tmp_path / "runs"
    out.mkdir()
    logs = _spawn("cli", out, str(tmp_path / "tartan"))
    assert all(f"CLI_DONE rank {r}" in o for r, o in enumerate(logs))
    ck0 = sorted(os.listdir(out / "rank0" / "checkpoints"))
    assert ck0 == ["mp_000001.npz", "mp_000002.npz"]
    assert not os.path.exists(out / "rank1" / "checkpoints")
    assert os.path.exists(out / "rank0" / "runs") and not os.path.exists(out / "rank1" / "runs")
