"""The port's viz/ against the JAX package's on the CPU: backproject_points
within 1e-5 and depth_filter's counts equal on seeded poses and
disparities; reconstruction_pointcloud's points within 1e-5 and colors
equal; export_ply the same bytes for the same arrays; and a port Droid
with ``vis_path`` streaming its PLY while it tracks, as the JAX package's
tests/test_viz_live.py runs the JAX Droid.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu import viz as jviz
from droid_slam_reserch_tpu_torch import viz as tviz
from droid_slam_reserch_tpu_torch.engine import Droid as TDroid
from droid_slam_reserch_tpu_torch.lie import se3_exp
from test_engine import INTR, synth_frame
from test_torch_engine import torch_config

torch.set_num_threads(1)
P, H, W = 9, 12, 16


def _state(seed=0):
    """A seeded session: poses along a short path with small rotations,
    smooth disparities, images and intrinsics at 8x their resolution."""
    rng = np.random.RandomState(seed)
    xi = np.zeros((P, 6), np.float32)
    xi[:, 0] = 0.05 * np.arange(P)
    xi += 0.01 * rng.randn(P, 6).astype(np.float32)
    poses = se3_exp(torch.from_numpy(xi)).numpy()
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    disps = (0.5 + 0.2 * np.sin(0.3 * xs + 0.2 * ys)[None]
             + 0.05 * rng.rand(P, H, W)).astype(np.float32)
    intr = np.tile(np.array([12.0, 12.0, W / 2.0, H / 2.0], np.float32), (P, 1))
    images = rng.randint(0, 256, (P, 8 * H, 8 * W, 3)).astype(np.uint8)
    return {"poses": poses, "disps": disps, "intrinsics": intr, "images": images}


def test_backproject_points_matches_jax():
    s = _state()
    ref = np.asarray(jviz.backproject_points(jnp.asarray(s["poses"]), jnp.asarray(s["disps"]),
                                             jnp.asarray(s["intrinsics"][0])))
    out = tviz.backproject_points(torch.from_numpy(s["poses"]), torch.from_numpy(s["disps"]),
                                  torch.from_numpy(s["intrinsics"][0])).numpy()
    assert out.shape == ref.shape == (P, H, W, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("thresh", [0.002, 0.02])
def test_depth_filter_counts_match_jax(thresh):
    s = _state(1)
    ix = np.array([0, 2, 4, 8])
    th = thresh * np.ones(len(ix))
    ref = np.asarray(jviz.depth_filter(jnp.asarray(s["poses"]), jnp.asarray(s["disps"]),
                                       jnp.asarray(s["intrinsics"][0]), ix, th))
    out = tviz.depth_filter(torch.from_numpy(s["poses"]), torch.from_numpy(s["disps"]),
                            torch.from_numpy(s["intrinsics"][0]), ix, th).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape == (len(ix), H, W)
    np.testing.assert_array_equal(out, ref)
    assert 0 < out.mean() < 6          # neither nothing nor everything agrees


def test_reconstruction_pointcloud_and_ply_match_jax(tmp_path):
    s = _state(2)
    pts_j, clr_j = jviz.reconstruction_pointcloud(s, filter_count=1)
    pts_t, clr_t = tviz.reconstruction_pointcloud(s, filter_count=1, device="cpu")
    assert pts_t.shape == pts_j.shape and len(pts_t) > 0
    np.testing.assert_allclose(pts_t, pts_j, atol=1e-5)
    np.testing.assert_array_equal(clr_t, clr_j)

    for colors in (clr_j, None):
        jviz.export_ply(str(tmp_path / "j.ply"), pts_j, colors)
        tviz.export_ply(str(tmp_path / "t.ply"), pts_j, colors)
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    assert (tmp_path / "t.ply").read_text().startswith("ply\nformat ascii 1.0\n")


def test_open3d_viewer_absent_as_in_jax(tmp_path):
    """Without open3d both engines' try_open3d_viewer return False."""
    try:
        import open3d  # noqa: F401
        pytest.skip("open3d imports here")
    except ImportError:
        pass
    v = tviz.LiveViewer(None, out_path=str(tmp_path / "x.ply"))
    assert tviz.try_open3d_viewer(v) is jviz.live.try_open3d_viewer(v) is False


def test_live_viewer_streams_pointcloud(tmp_path):
    """A port Droid with vis_path: the viewer thread refreshes while the
    Droid tracks; terminate re-dirties every keyframe, and the viewer's
    last refresh replaces their points (no duplicates) and leaves no slot
    dirty."""
    out = str(tmp_path / "live.ply")
    droid = TDroid(torch_config(vis_path=out), device="cpu")
    assert droid.viewer is not None
    rng = np.random.RandomState(0)
    for t in range(10):
        droid.track(float(t), synth_frame(t, rng), intrinsics=INTR)

    # one synchronous drain, so the test does not race the poll timer
    droid.viewer.refresh_once()
    droid.viewer._write()
    assert os.path.exists(out)
    refreshes = droid.viewer.refreshes
    assert refreshes >= 1
    t = droid.video.counter
    assert sorted(droid.viewer.points) == list(range(t))

    droid.terminate()
    assert droid.viewer.refreshes > refreshes
    assert not droid.viewer._thread.is_alive()
    pts, clr = droid.viewer.cloud()
    assert len(pts) == len(clr) == sum(len(p) for p in droid.viewer.points.values())
    assert sorted(droid.viewer.points) == list(range(t))
    assert np.isfinite(pts).all()
    assert not droid.video.dirty[:t].any()
    with open(out) as f:
        head = f.read(200)
    assert head.startswith("ply") and f"element vertex {len(pts)}\n" in head
    # the cloud is the final state's: each keyframe's points from its final pose
    v = droid.video
    ref = tviz.backproject_points(v.poses[:t], v.disps[:t], v.intrinsics[0]).numpy()
    k = max(droid.viewer.points, key=lambda i: len(droid.viewer.points[i]))
    assert len(droid.viewer.points[k]) > 0
    assert np.isin(droid.viewer.points[k][:, 0], ref[k][..., 0]).all()
