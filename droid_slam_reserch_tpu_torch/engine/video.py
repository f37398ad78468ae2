"""Keyframe buffer (mirror of engine/video.py): fixed-capacity tensors on
the engine's device, updated in place; images stay on the host."""
import numpy as np
import torch

from ..geom import frame_distance, projective_transform
from ..lie import se3_identity


class Video:
    def __init__(self, config, device="cuda"):
        self.cfg = config
        self.device = dev = torch.device(device)
        ht, wd = config.image_size
        self.ht, self.wd = ht, wd
        self.h8, self.w8 = h8, w8 = ht // 8, wd // 8
        buf = config.buffer
        self.stereo = config.stereo

        self.counter = 0
        self.tstamp = np.zeros(buf, dtype=np.float64)
        self.images = np.zeros((buf, ht, wd, 3), dtype=np.uint8)

        self.poses = se3_identity((buf,), device=dev)
        self.disps = torch.ones(buf, h8, w8, device=dev)
        self.disps_sens = torch.zeros(buf, h8, w8, device=dev)
        self.intrinsics = torch.zeros(buf, 4, device=dev)
        self.damping = torch.full((buf, h8, w8), 1e-6, device=dev)

        self.fmaps = torch.zeros(buf, 1, h8, w8, 128, device=dev)
        self.nets = torch.zeros(buf, h8, w8, 128, device=dev)
        self.inps = torch.zeros(buf, h8, w8, 128, device=dev)

    def append(self, tstamp, image, pose, disp, depth, intrinsics, fmap, net=None, inp=None):
        """Add a keyframe at slot ``counter``.

        image [ht, wd, 3] uint8 (host) or None; pose [7] or None; disp a
        scalar or [h8, w8] or None; fmap [1, h8, w8, 128]; net/inp [h8, w8, 128].
        """
        if depth is not None:
            raise NotImplementedError("RGB-D tracking is not part of this slice of the port")
        ix = self.counter
        self.tstamp[ix] = tstamp
        if image is not None:
            self.images[ix] = np.asarray(image, dtype=np.uint8)
        if pose is not None:
            self.poses[ix] = torch.as_tensor(pose, dtype=torch.float32, device=self.device)
        if disp is not None:
            self.disps[ix] = torch.as_tensor(disp, dtype=torch.float32, device=self.device)
        if intrinsics is not None:
            self.intrinsics[ix] = torch.as_tensor(intrinsics, dtype=torch.float32,
                                                  device=self.device)
        if fmap is not None:
            self.fmaps[ix] = fmap
        if net is not None:
            self.nets[ix] = net
        if inp is not None:
            self.inps[ix] = inp
        self.counter = ix + 1

    def remove_keyframe(self, ix):
        """Copy slot ix+1 down into ix (reference factor_graph.py:165-178)."""
        self.tstamp[ix] = self.tstamp[ix + 1]
        self.images[ix] = self.images[ix + 1]
        for name in ("poses", "disps", "disps_sens", "intrinsics", "fmaps", "nets",
                     "inps", "damping"):
            buf = getattr(self, name)
            buf[ix] = buf[ix + 1]

    def _index(self, ix):
        return torch.as_tensor(np.asarray(ix, np.int64).reshape(-1), device=self.device)

    def reproject(self, ii, jj):
        """coords, valid for edges ii -> jj."""
        return projective_transform(self.poses[None], self.disps[None], self.intrinsics[None],
                                    self._index(ii), self._index(jj))

    def distance(self, ii, jj, beta=0.3, bidirectional=True):
        """Mean-flow frame distance between frame pairs (host numpy result)."""
        ii = np.asarray(ii, np.int64).reshape(-1)
        jj = np.asarray(jj, np.int64).reshape(-1)
        n = len(ii)
        if bidirectional:
            ii, jj = np.concatenate([ii, jj]), np.concatenate([jj, ii])
        d = frame_distance(self.poses, self.disps, self.intrinsics[0],
                           self._index(ii), self._index(jj), beta=beta)
        d = d.cpu().numpy()
        return 0.5 * (d[:n] + d[n:]) if bidirectional else d

    def distance_matrix(self, t0, t1, t, beta=0.3):
        """Bidirectional distances for the pairs [t0, t) x [t1, t)."""
        ii, jj = np.meshgrid(np.arange(t0, t), np.arange(t1, t), indexing="ij")
        return self.distance(ii, jj, beta=beta).reshape(t - t0, t - t1)

    def state_dict(self):
        t = self.counter
        return {
            "tstamps": self.tstamp[:t].copy(),
            "images": self.images[:t].copy(),
            **{k: getattr(self, k)[:t].cpu().numpy()
               for k in ("poses", "disps", "disps_sens", "intrinsics", "fmaps", "nets", "inps")},
        }
