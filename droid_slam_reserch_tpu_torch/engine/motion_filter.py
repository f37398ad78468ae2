"""Keyframe admission by flow magnitude (mirror of engine/motion_filter.py).

Per frame: fnet features, a one-step update-operator motion check against
the last keyframe (a 1-edge correlation at the grid coords, one GRU step,
no BA) and, when the frame is admitted, cnet context features.  A stereo
frame's fnet runs on both cameras; the motion check and cnet take the left
one, and the video stores the left image.  The 1-edge correlation goes
through K2 and K3 like the frontend's: an fp32 volume from features in the
compute dtype (the JAX package's corr_volume), cast to the compute dtype at
the update operator's input.
"""
import numpy as np
import torch

from ..geom import coords_grid
from ..lie import se3_identity
from ..ops.cuda_corr import corr_build, corr_lookup
from ..utils.timing import count, count_sync, section, set_request
from .net_ops import cnet_apply, fnet_apply


class MotionFilter:
    def __init__(self, net, video, thresh=2.4):
        self.net = net
        self.video = video
        self.thresh = thresh
        self.count = 0
        self.fmap = None
        self.hidden = None
        self.inp = None

    def delta_norm(self, gmap):
        """The mean flow correction of one update-operator step for features
        gmap [c, h8, w8, 128] against the last keyframe's, left camera
        against left camera (a 0-d tensor)."""
        h8, w8 = gmap.shape[1:3]
        coords0 = coords_grid(h8, w8, device=gmap.device).reshape(1, h8 * w8, 2)
        with section("corr"):
            levels = corr_build(self.fmap[:1].contiguous(), gmap[:1].contiguous(), torch.float32)
            corr = corr_lookup(levels, coords0).reshape(1, 1, h8, w8, -1)
        count("edges")
        count("edge_slots")
        _, delta, _ = self.net.update(self.hidden[None, None], self.inp[None, None],
                                      corr.to(self.hidden.dtype))
        return delta[0, 0].float().norm(dim=-1).mean()

    def _first_pose_disp(self, device):
        """The pose and disparity frame 0 is appended with."""
        return se3_identity(device=device), 1.0

    def track(self, tstamp, image, depth=None, intrinsics=None):
        """Process one frame: image [H, W, 3] uint8 BGR (host), or [2, H, W, 3]
        for stereo (left, right); depth an optional [H, W] depth map.  The
        frame's timestamp becomes the tracer's request."""
        set_request(tstamp)
        with section("motion_filter.track"):
            return self._track(tstamp, image, depth, intrinsics)

    def _track(self, tstamp, image, depth, intrinsics):
        video = self.video
        dev = video.device
        with section("upload"):
            image = np.asarray(image)
            if image.ndim == 3:
                image = image[None]
            imgs = torch.as_tensor(image.astype(np.float32), device=dev)
            intr = torch.as_tensor(np.asarray(intrinsics, np.float32), device=dev) / 8.0
        gmap = fnet_apply(self.net, imgs)

        if video.counter == 0:
            net, inp = cnet_apply(self.net, imgs[:1])
            self.hidden, self.inp, self.fmap = net[0], inp[0], gmap
            video.append(tstamp, image[0], *self._first_pose_disp(dev), depth, intr,
                         gmap, net[0], inp[0])
            return

        count_sync("admission")  # admission decision: the per-frame blocking sync
        if float(self.delta_norm(gmap)) > self.thresh:
            self.count = 0
            net, inp = cnet_apply(self.net, imgs[:1])
            self.hidden, self.inp, self.fmap = net[0], inp[0], gmap
            video.append(tstamp, image[0], None, None, depth, intr, gmap, net[0], inp[0])
        else:
            self.count += 1


class SessionMotionFilter(MotionFilter):
    """Multisession variant (reference s_motion_filter.py:78-80): frame 0 is
    appended with pose=None and disp=None, so that poses and disparities
    written into the buffer before tracking (a loop session's seeds) stay."""

    def _first_pose_disp(self, device):
        return None, None
