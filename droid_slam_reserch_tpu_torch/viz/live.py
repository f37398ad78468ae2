"""Live visualization consumer (mirror of viz/live.py).

The reference's separate visualization process (reference droid.py:40-43
starts visualization.py:60-163, which polls the DepthVideo's ``dirty``
flags every animation frame) becomes a daemon thread here: it polls
``video.dirty``, snapshots the buffers (the frontend writes them in place,
so the thread clones its slice on the engine's device and copies the clone
to the host, which waits for the stream and nothing else), re-runs the
depth-consistency filter for the dirty keyframes, and keeps one point set
per keyframe.  Sinks:

- a PLY stream (default): the merged cloud is rewritten atomically after
  every refresh, so any viewer watching the file (or ``cli view``) shows
  the reconstruction growing;
- an Open3D window where open3d imports (the reference's actor
  replacement, visualization.py:117-141).

A keyframe edited later (BA moves poses and disparities and sets ``dirty``
again, reference depth_video.py:23-46) is snapshotted again and its points
replaced, as the reference removes and re-adds its actor.
"""
import os
import threading
import time

import numpy as np
import torch

from ..lie import se3_inv
from .pointcloud import backproject_points, depth_filter, export_ply

INTERVAL = 0.5          # s between polls of video.dirty
FILTER_THRESH = 0.005   # depth-consistency threshold (reference visualization.py:108)
FILTER_COUNT = 2        # consistent neighbours a point needs
WARMUP = 2              # keyframes before the first refresh


class LiveViewer:
    """Consumes ``video.dirty`` and keeps a live point cloud (reference
    visualization.py:84-141, animation_callback): drain the dirty indices,
    filter their depths, replace those keyframes' geometry."""

    def __init__(self, video, out_path="live.ply"):
        self.video = video
        self.out_path = out_path
        self.points = {}   # keyframe ix -> [N, 3]
        self.colors = {}   # keyframe ix -> [N, 3]
        self.cameras = {}  # keyframe ix -> [3] camera center (trail)
        self.refreshes = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="LiveViewer")

    def start(self):
        self._thread.start()
        return self

    def stop(self, final_flush=True):
        self._stop.set()
        self._thread.join(timeout=10)
        if final_flush:
            self.refresh_once()
            self._write()

    def _run(self):
        while not self._stop.is_set():
            try:
                if self.refresh_once():
                    self._write()
            except Exception:
                # the viewer must never take down tracking
                pass
            self._stop.wait(INTERVAL)

    def refresh_once(self):
        """Drain the dirty keyframes and rebuild their points; returns how
        many were updated."""
        v = self.video
        t = int(v.counter)
        if t < WARMUP:
            return 0
        dirty = np.where(v.dirty[:t])[0]
        if len(dirty) == 0:
            return 0
        v.dirty[dirty] = False

        with torch.no_grad():
            # a snapshot of the slice: the frontend writes the buffers in place
            poses = v.poses[:t].clone()
            disps = v.disps[:t].clone()
            intr = v.intrinsics[0].clone()
            ix = torch.as_tensor(dirty, device=poses.device)
            pts = backproject_points(poses[ix], disps[ix], intr).cpu().numpy()
            disps_np = disps[ix].cpu().numpy()
            # a constant threshold per frame (reference visualization.py:108
            # uses filter_thresh * ones_like(...), not scaled by the disparity)
            thresh = FILTER_THRESH * np.ones(len(dirty))
            counts = depth_filter(poses, disps, intr, dirty, thresh).cpu().numpy()
            cams = se3_inv(poses[ix])[:, :3].cpu().numpy()
        masks = (counts >= FILTER_COUNT) & (
            disps_np > 0.5 * disps_np.mean(axis=(1, 2), keepdims=True)
        )

        H8, W8 = disps_np.shape[1:]
        for k, i in enumerate(dirty):
            color = v.images[i][3::8, 3::8][:H8, :W8, ::-1] / 255.0
            m = masks[k]
            self.points[int(i)] = pts[k][m]
            self.colors[int(i)] = color[m]
            self.cameras[int(i)] = cams[k]
        self.refreshes += 1
        return len(dirty)

    def cloud(self):
        """Merged (points, colors) of every keyframe seen so far."""
        if not self.points:
            return np.zeros((0, 3)), np.zeros((0, 3))
        keys = sorted(self.points)
        pts = np.concatenate([self.points[k] for k in keys], axis=0)
        clr = np.concatenate([self.colors[k] for k in keys], axis=0)
        return pts, clr

    def _write(self):
        pts, clr = self.cloud()
        tmp = self.out_path + ".tmp"
        export_ply(tmp, pts, clr)
        os.replace(tmp, self.out_path)  # atomic for external watchers


def try_open3d_viewer(viewer, height=540, width=960):
    """Attach an Open3D window to a running LiveViewer (reference
    visualization.py:155-163).  Returns False when open3d does not import."""
    try:
        import open3d as o3d
    except ImportError:
        return False

    vis = o3d.visualization.Visualizer()
    vis.create_window(height=height, width=width)
    pcd = o3d.geometry.PointCloud()
    vis.add_geometry(pcd)
    last = -1
    while not viewer._stop.is_set():
        if viewer.refreshes != last:
            last = viewer.refreshes
            pts, clr = viewer.cloud()
            pcd.points = o3d.utility.Vector3dVector(pts)
            pcd.colors = o3d.utility.Vector3dVector(clr)
            vis.update_geometry(pcd)
        if not vis.poll_events():
            break
        vis.update_renderer()
        time.sleep(0.03)
    vis.destroy_window()
    return True
