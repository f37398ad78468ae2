"""Droid facade (mirror of engine/droid.py): motion filter -> frontend ->
backend -> trajectory filler, and the multisession ``SDroid``.

The port runs mono, stereo (``config.stereo``: [2, H, W, 3] frames, left
and right) and RGB-D (``config.rgbd``: a depth map with each frame)
tracking and the global refinement that ends it, in fp32 or bf16
(``compute_dtype``); with ``config.upsample`` the frontend and the backend
keep full-resolution disparities in ``video.disps_up``.  With
``config.vis_path`` a LiveViewer thread streams the keyframes' point cloud
into that PLY file while tracking runs (viz/live.py).
"""
import os

import numpy as np
import torch

from ..lie import se3_inv
from ..models import DroidNet, init_params, load_weights
from ..utils.npz import savez_compressed
from ..utils.timing import maybe_report, next_call, section, set_request
from ..viz.live import LiveViewer
from .backend import Backend
from .frontend import Frontend, SessionFrontend
from .motion_filter import MotionFilter, SessionMotionFilter
from .net_ops import compute_dtype, update_apply
from .trajectory_filler import TrajectoryFiller
from .video import Video


def resolve_device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return device


def default_params(config):
    """The weights a Droid runs without ``params``: ``config.weights``, else
    the seeded random ones (CPU tensors)."""
    return load_weights(config.weights) if config.weights else init_params(seed=0)


class Droid:
    filter_cls = MotionFilter
    frontend_cls = Frontend

    def __init__(self, config, params=None, device="cuda"):
        self.cfg = config
        self.dtype = compute_dtype(config.compute_dtype)
        self.device = resolve_device(device)
        if params is None:
            params = default_params(config)
        # fp32 weights, cast once to the compute dtype (round to nearest even,
        # as Flax casts them at each layer)
        self.net = DroidNet()
        self.net.load_state_dict(params)
        self.net.to(self.device, self.dtype).eval().requires_grad_(False)

        self.video = Video(config, self.device)
        self.filterx = self.filter_cls(self.net, self.video, thresh=config.filter_thresh)
        self.frontend = self.frontend_cls(update_apply, self.net.update, self.video, config)
        self.backend = Backend(update_apply, self.net.update, self.video, config)
        self.traj_filler = TrajectoryFiller(self.net, update_apply, self.video, config)

        # the live viewer (reference droid.py:40-43 starts a viewer process
        # that polls video.dirty; here a host thread streams a PLY)
        self.viewer = None
        if config.vis_path:
            self.viewer = LiveViewer(self.video, out_path=config.vis_path).start()

    @torch.no_grad()
    def track(self, tstamp, image, depth=None, intrinsics=None):
        """Per-frame tracking (reference droid.py:76-90): image [H, W, 3]
        uint8 BGR, or [2, H, W, 3] for stereo; depth an optional [H, W]
        depth map (RGB-D); intrinsics [4]."""
        set_request(tstamp)
        with section("track"):
            self.filterx.track(tstamp, image, depth, intrinsics)
            self.frontend()

    @torch.no_grad()
    def terminate(self, stream=None):
        """Global refinement (reference droid.py:114-126): two backend runs,
        the viewer's last refresh, then the timing summary when DROID_TIMING
        is set."""
        next_call()
        with section("terminate"):
            self._refine()
        maybe_report()

    def _refine(self):
        del self.frontend
        self.backend(self.cfg.backend_steps_first)
        self.backend(self.cfg.backend_steps_second)
        if self.viewer is not None:
            self.viewer.stop()

    @torch.no_grad()
    def terminate_eva(self, stream):
        """Backend, then the trajectory filler over ``stream`` (tstamp, image,
        intrinsics; images as ``track`` takes them); returns the camera
        trajectory [T, 7] (the inverted world-to-camera poses, reference
        droid.py:132-146).  Then the timing summary when DROID_TIMING is set."""
        next_call()
        with section("terminate"):
            self._refine()
            traj = self.terminate_eva_second(stream)
        maybe_report()
        return traj

    def terminate_eva_second(self, stream):
        """Trajectory fill only (reference droid.py:148-153)."""
        if hasattr(self, "frontend"):
            del self.frontend
        poses = torch.as_tensor(self.traj_filler(stream))
        return se3_inv(poses).numpy()

    def save_reconstruction(self, path):
        """Dump the session state as reconstruction.npz plus one .npy per key."""
        os.makedirs(path, exist_ok=True)
        state = self.video.state_dict()
        savez_compressed(os.path.join(path, "reconstruction.npz"), **state)
        for k, v in state.items():
            np.save(os.path.join(path, f"{k}.npy"), v)

    def save_backend_finished_poses(self, path):
        """reference droid.py:108-111."""
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "backend_finished_poses.npy"),
                self.video.poses[: self.video.counter].cpu().numpy())


class SDroid(Droid):
    """Multisession variant (reference s_droid.py:20-112): the session motion
    filter (slots written before tracking keep their poses and
    disparities) and the quality-gated frontend (``config.good=False``);
    its terminate() is Droid's: the two backend runs, no filler."""

    filter_cls = SessionMotionFilter
    frontend_cls = SessionFrontend
