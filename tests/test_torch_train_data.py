"""The port's training data against the JAX package's, from the same seeds
(CPU; cv2 writes the PNGs and serves the JAX side only), and the port's
CLI ``train`` on a synthetic TartanAir scene.

- RGBDAugmentor: poses, intrinsics and nearest-resized disparities equal,
  images within 2e-3 of 255 (OpenCV's float INTER_LINEAR against the
  port's, which round alike but not always identically);
- compute_distance_matrix_flow within 1e-4 relative, inf where JAX has inf;
- sample_frame_graph: identical graphs (both branches);
- TartanAir: the same scene index and, item by item, the same arrays
  (images within 2e-3 of 255 as above, the rest within 1e-5);
- ``train --device cpu``: two steps with checkpoints, then a resume to
  three with the optimizer state carried over, read by the JAX package's
  load_ckpt.  (The augmentation's rng is the dataset's own, unseeded, as in
  the JAX package, so a resumed run replays item and graph draws, not the
  augmentation; exact resume is held in test_torch_train_optim.py.)"""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu import lie as jlie
from droid_slam_reserch_tpu.data import RGBDAugmentor as JAugmentor
from droid_slam_reserch_tpu.data import TartanAir as JTartanAir
from droid_slam_reserch_tpu.data import compute_distance_matrix_flow as j_distance
from droid_slam_reserch_tpu.train import load_ckpt as j_load_ckpt
from droid_slam_reserch_tpu.train.step import sample_frame_graph as j_sample
from droid_slam_reserch_tpu_torch.cli import main
from droid_slam_reserch_tpu_torch.data import RGBDAugmentor, TartanAir, compute_distance_matrix_flow
from droid_slam_reserch_tpu_torch.models import params_from_jax
from droid_slam_reserch_tpu_torch.train import load_ckpt
from droid_slam_reserch_tpu_torch.train.step import sample_frame_graph

torch.set_num_threads(2)
IMG_TOL = 2e-3 * 255


@pytest.fixture(scope="module")
def tartan_root(tmp_path_factory):
    """A TartanAir-layout scene, root/*/*/*/*: 14 frames of 480x640 PNGs,
    npy depths and NED poses moving forward (mean flow ~16 px)."""
    root = tmp_path_factory.mktemp("tartan")
    scene = root / "env" / "env" / "Easy" / "P001"
    (scene / "image_left").mkdir(parents=True)
    (scene / "depth_left").mkdir(parents=True)
    rng = np.random.RandomState(0)
    H, W, T = 480, 640, 14
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    poses = []
    for t in range(T):
        img = np.clip(127 + 90 * np.sin(0.05 * (xs + 25 * t)) * np.cos(0.04 * ys)
                      + 10 * rng.standard_normal((H, W)), 0, 255).astype(np.uint8)
        cv2.imwrite(str(scene / "image_left" / f"{t:06d}.png"), np.repeat(img[..., None], 3, -1))
        depth = 2.0 + 0.2 * np.sin(0.01 * xs) * np.cos(0.01 * ys)
        np.save(scene / "depth_left" / f"{t:06d}.npy", depth.astype(np.float32))
        poses.append([0.0, 0.1 * t, 0.0, 0.0, 0.0, 0.0, 1.0])
    np.savetxt(scene / "pose_left.txt", np.asarray(poses), delimiter=" ")
    return root


def test_augmentor():
    rng = np.random.RandomState(1)
    images = rng.uniform(0, 255, (3, 60, 80, 3)).astype(np.float32)
    disps = rng.uniform(0.1, 1.0, (3, 60, 80)).astype(np.float32)
    poses = rng.standard_normal((3, 7)).astype(np.float32)
    intr = np.tile(np.array([50.0, 50.0, 40.0, 30.0], np.float32), (3, 1))
    for seed in range(6):
        out_t = RGBDAugmentor((40, 48), rng=np.random.default_rng(seed))(images, poses, disps, intr)
        out_j = JAugmentor((40, 48), rng=np.random.default_rng(seed))(images, poses, disps, intr)
        np.testing.assert_allclose(out_t[0], out_j[0], atol=IMG_TOL, rtol=0)
        for a, b in zip(out_t[1:], out_j[1:]):
            np.testing.assert_array_equal(a, b)


def _random_trajectory(seed, N=6, h=12, w=16):
    rng = np.random.RandomState(seed)
    xi = np.concatenate([0.3 * rng.standard_normal((N, 3)), 0.05 * rng.standard_normal((N, 3))], 1)
    poses = np.array(jlie.se3_exp(jnp.asarray(xi, jnp.float32)))
    disps = rng.uniform(0.2, 1.0, (N, h, w)).astype(np.float32)
    intr = np.tile(np.array([12.0, 12.0, w / 2, h / 2], np.float32), (N, 1))
    return poses, disps, intr


def test_distance_matrix_flow():
    for seed in range(3):
        poses, disps, intr = _random_trajectory(seed)
        dt = compute_distance_matrix_flow(poses, disps, intr, chunk=7)
        dj = j_distance(poses, disps, intr)
        np.testing.assert_array_equal(np.isinf(dt), np.isinf(dj))
        fin = np.isfinite(dj)
        assert fin.sum() > 6
        np.testing.assert_allclose(dt[fin], dj[fin], rtol=1e-4, atol=1e-4)


def test_sample_frame_graph():
    P = 6
    rng = np.random.RandomState(4)
    poses = np.array(jlie.se3_exp(jnp.asarray(0.05 * rng.standard_normal((1, P, 6)), jnp.float32)))
    disps = rng.uniform(0.5, 1.0, (1, P, 64, 64)).astype(np.float32)
    intr = np.tile(np.array([40.0, 40.0, 32.0, 32.0], np.float32), (1, P, 1))
    sizes = set()
    for seed in range(8):
        gt = sample_frame_graph(np.random.default_rng(seed), poses, disps, intr, P, 28)
        gj = j_sample(np.random.default_rng(seed), poses, disps, intr, P, 28)
        for a, b in zip(gt, gj):
            np.testing.assert_array_equal(a, b)
        sizes.add(int(gt[2].sum()))
    assert len(sizes) == 2                                  # both branches drawn


def test_tartanair_items(tartan_root, tmp_path):
    kw = dict(datapath=str(tartan_root), n_frames=4, crop_size=(64, 96), fmin=8.0, fmax=96.0)
    dt = TartanAir(cache_dir=str(tmp_path / "t"), rng=np.random.default_rng(5), **kw)
    dj = JTartanAir(cache_dir=str(tmp_path / "j"), rng=np.random.default_rng(5), **kw)
    assert dt.dataset_index == dj.dataset_index and len(dt) > 0
    for scene in dt.scene_info:
        for i, (jt, dist_t) in dt.scene_info[scene]["graph"].items():
            jj, dist_j = dj.scene_info[scene]["graph"][i]
            np.testing.assert_array_equal(jt, jj)
            np.testing.assert_allclose(dist_t, dist_j, rtol=1e-4)
    for index in (0, 3, 5):
        it, ij = dt[index], dj[index]
        np.testing.assert_allclose(it[0], ij[0], atol=IMG_TOL, rtol=0)
        for a, b in zip(it[1:], ij[1:]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_cli_train_and_resume(tartan_root, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)                     # checkpoints/ and runs/ land here
    args = ["train", "--datapath", str(tartan_root), "--steps", "2", "--n_frames", "4",
            "--iters", "1", "--image_size", "64", "64", "--save_every", "1",
            "--restart_prob", "0.5", "--device", "cpu"]
    main(args + ["--name", "smoke"])
    ck = tmp_path / "checkpoints"
    assert (ck / "smoke_000001.npz").exists() and (ck / "smoke_000002.npz").exists()
    main(args[:4] + ["3"] + args[5:] + ["--name", "smoke", "--ckpt", str(ck / "smoke_000002.npz")])
    p2, s2, _ = load_ckpt(str(ck / "smoke_000002.npz"))
    p_res, s_res, step = load_ckpt(str(ck / "smoke_000003.npz"))
    assert step == 3 and s_res["count"] == 3
    for k in p_res:
        assert torch.isfinite(p_res[k]).all() and not torch.equal(p_res[k], p2[k]), k
    jparams, _, jstep = j_load_ckpt(str(ck / "smoke_000003.npz"))
    assert jstep == 3
    back = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert all(torch.equal(back[k], p_res[k]) for k in p_res)
    assert os.path.isdir(tartan_root / ".droid_cache")
