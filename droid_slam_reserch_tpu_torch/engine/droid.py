"""Droid facade (mirror of engine/droid.py): motion filter -> frontend ->
backend -> trajectory filler.

This slice runs mono tracking and the global refinement that ends it; the
other sensor modes, upsampling, bf16 and the viewer raise
``NotImplementedError``.
"""
import os

import numpy as np
import torch

from ..lie import se3_inv
from ..models import DroidNet, init_params, load_weights
from .backend import Backend
from .frontend import Frontend
from .motion_filter import MotionFilter
from .net_ops import update_apply
from .trajectory_filler import TrajectoryFiller
from .video import Video


def resolve_device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but CUDA is not available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return device


class Droid:
    def __init__(self, config, params=None, device="cuda"):
        for flag, what in ((config.upsample, "upsample"), (config.stereo, "stereo"),
                           (config.rgbd, "rgbd"), (config.vis_path, "the live viewer"),
                           (config.compute_dtype != "float32", "bfloat16 compute_dtype")):
            if flag:
                raise NotImplementedError(f"{what} is not part of this slice of the port")
        self.cfg = config
        self.device = resolve_device(device)
        if params is None:
            params = load_weights(config.weights) if config.weights else init_params(seed=0)
        self.net = DroidNet()
        self.net.load_state_dict(params)
        self.net.to(self.device).eval().requires_grad_(False)

        self.video = Video(config, self.device)
        self.filterx = MotionFilter(self.net, self.video, thresh=config.filter_thresh)
        self.frontend = Frontend(update_apply, self.net.update, self.video, config)
        self.backend = Backend(update_apply, self.net.update, self.video, config)
        self.traj_filler = TrajectoryFiller(self.net, update_apply, self.video, config)

    @torch.no_grad()
    def track(self, tstamp, image, depth=None, intrinsics=None):
        """Per-frame tracking: image [H, W, 3] uint8 BGR, intrinsics [4]."""
        if np.ndim(image) != 3:
            raise NotImplementedError("stereo tracking is not part of this slice of the port")
        self.filterx.track(tstamp, image, depth, intrinsics)
        self.frontend()

    @torch.no_grad()
    def terminate(self, stream=None):
        """Global refinement (reference droid.py:114-126): two backend runs."""
        del self.frontend
        self.backend(self.cfg.backend_steps_first)
        self.backend(self.cfg.backend_steps_second)

    def terminate_eva(self, stream):
        """Backend, then the trajectory filler over ``stream`` (tstamp, image,
        intrinsics); returns the camera trajectory [T, 7] (the inverted
        world-to-camera poses, reference droid.py:132-146)."""
        self.terminate()
        return self.terminate_eva_second(stream)

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
        np.savez_compressed(os.path.join(path, "reconstruction.npz"), **state)
        for k, v in state.items():
            np.save(os.path.join(path, f"{k}.npy"), v)

    def save_backend_finished_poses(self, path):
        """reference droid.py:108-111."""
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "backend_finished_poses.npy"),
                self.video.poses[: self.video.counter].cpu().numpy())
