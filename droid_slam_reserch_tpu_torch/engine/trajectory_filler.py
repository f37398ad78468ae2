"""Non-keyframe pose recovery (mirror of engine/trajectory_filler.py;
reference trajectory_filler.py:12-103).

Chunks of 16 frames: SE3 interpolation between the bracketing keyframes,
fnet features only (of every camera of a stereo frame), temporary slots
with edges from both brackets, 6 motion-only rounds of update_fused, then
the slots are released.
"""
import numpy as np
import torch

from ..lie import se3_exp, se3_inv, se3_log, se3_mul
from ..utils.timing import count_sync, section
from .factor_graph import FactorGraph
from .net_ops import fnet_apply


class TrajectoryFiller:
    def __init__(self, net, update_apply, video, config):
        self.net = net
        self.update_apply = update_apply
        self.video = video
        self.cfg = config

    def _fill(self, tstamps, images, intrinsics):
        """Fill one chunk (reference :35-77); returns its poses [M, 7] (host)."""
        v = self.video
        dev = v.device
        N = v.counter
        M = len(tstamps)

        ts = v.tstamp[:N]
        t0 = np.clip(np.array([np.sum(ts <= t) - 1 for t in tstamps]), 0, N - 1)
        t1 = np.where(t0 < N - 1, t0 + 1, t0)

        Ps = v.poses[:N]
        i0, i1 = torch.as_tensor(t0, device=dev), torch.as_tensor(t1, device=dev)
        dt = torch.as_tensor(ts[t1] - ts[t0] + 1e-3, dtype=torch.float32, device=dev)[:, None]
        vlog = se3_log(se3_mul(Ps[i1], se3_inv(Ps[i0]))) / dt
        w = vlog * torch.as_tensor(np.asarray(tstamps, np.float64) - ts[t0],
                                   dtype=torch.float32, device=dev)[:, None]
        Gs = se3_mul(se3_exp(w), Ps[i0])

        # fnet on every camera; set_slot fits the cameras to the buffer's
        with section("upload"):
            imgs = np.stack([im if im.ndim == 4 else im[None] for im in images])  # [M, c, H, W, 3]
            c = imgs.shape[1]
            x = torch.as_tensor(imgs.reshape((-1,) + imgs.shape[2:]), dtype=torch.float32,
                                device=dev)
        fmaps = fnet_apply(self.net, x)
        fmaps = fmaps.reshape((M, c) + fmaps.shape[1:])
        for m in range(M):
            v.set_slot(N + m, tstamps[m], imgs[m, 0], Gs[m], None, None,
                       torch.as_tensor(intrinsics[m], dtype=torch.float32) / 8.0, fmaps[m])
        v.counter = N + M

        graph = FactorGraph(v, self.update_apply, self.net.update)
        graph.add_factors(t0, np.arange(N, N + M))
        graph.add_factors(t1, np.arange(N, N + M))
        graph.update_fused(6, t0=N, t1=N + M, use_inactive=False, motion_only=True)

        count_sync("filler")
        out = v.poses[N: N + M].cpu().numpy()
        v.counter = N
        return out

    @torch.no_grad()
    def __call__(self, image_stream):
        """Poses [T, 7] (world-to-camera, as video.poses) of every frame that
        image_stream yields as (tstamp, image, intrinsics [4]); image is
        [H, W, 3], [1, H, W, 3] or a stereo [2, H, W, 3]."""
        with section("filler"):
            pose_list, tstamps, images, intrinsics = [], [], [], []
            for tstamp, image, intrinsic in image_stream:
                tstamps.append(tstamp)
                images.append(np.asarray(image))
                intrinsics.append(np.asarray(intrinsic))
                if len(tstamps) == 16:
                    pose_list.append(self._fill(tstamps, images, intrinsics))
                    tstamps, images, intrinsics = [], [], []
            if tstamps:
                pose_list.append(self._fill(tstamps, images, intrinsics))
            return np.concatenate(pose_list, axis=0)
