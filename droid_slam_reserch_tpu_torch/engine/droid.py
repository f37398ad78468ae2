"""Droid facade (mirror of engine/droid.py): motion filter -> frontend.

This slice runs online mono tracking; the backend, the trajectory filler
and the other sensor modes raise ``NotImplementedError``.
"""
import os

import numpy as np
import torch

from ..models import DroidNet, init_params
from .frontend import Frontend
from .motion_filter import MotionFilter
from .net_ops import update_apply
from .video import Video

_SLICE2 = ("is slice 2 of the PyTorch port (backend update_lowmem with altcorr, "
           "trajectory filler); not implemented yet")


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
            params = (torch.load(config.weights, map_location="cpu", weights_only=True)
                      if config.weights else init_params(seed=0))
        self.net = DroidNet()
        self.net.load_state_dict(params)
        self.net.to(self.device).eval().requires_grad_(False)

        self.video = Video(config, self.device)
        self.filterx = MotionFilter(self.net, self.video, thresh=config.filter_thresh)
        self.frontend = Frontend(update_apply, self.net.update, self.video, config)

    @torch.no_grad()
    def track(self, tstamp, image, depth=None, intrinsics=None):
        """Per-frame tracking: image [H, W, 3] uint8 BGR, intrinsics [4]."""
        if np.ndim(image) != 3:
            raise NotImplementedError("stereo tracking is not part of this slice of the port")
        self.filterx.track(tstamp, image, depth, intrinsics)
        self.frontend()

    def terminate(self, stream=None):
        raise NotImplementedError("Droid.terminate " + _SLICE2)

    def terminate_eva(self, stream=None):
        raise NotImplementedError("Droid.terminate_eva " + _SLICE2)

    def save_reconstruction(self, path):
        """Dump the session state as reconstruction.npz plus one .npy per key."""
        os.makedirs(path, exist_ok=True)
        state = self.video.state_dict()
        np.savez_compressed(os.path.join(path, "reconstruction.npz"), **state)
        for k, v in state.items():
            np.save(os.path.join(path, f"{k}.npy"), v)
