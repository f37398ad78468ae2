"""Keyframe buffer (mirror of engine/video.py): fixed-capacity tensors on
the engine's device, updated in place; images stay on the host.  A stereo
buffer keeps both cameras' features (``fmaps`` [buf, 2, h8, w8, 128]); an
RGB-D frame's depth becomes its sensor disparity ``disps_sens``.  With
``config.upsample`` the factor graphs fill ``disps_up``, the disparities at
full resolution.  A large global BA may run keyframe-sharded
(``cfg.ba_shards``, parallel/dist_ba.py)."""
import numpy as np
import torch

from .. import native
from ..ba.solver import ba_iterations
from ..geom import frame_distance, projective_transform
from ..lie import se3_identity
from ..models.update import cvx_upsample
from ..parallel import (dist_ba_solve, local_device_count, local_devices, make_mesh,
                        partition_edges, resolve_exchange)
from ..utils.log import log_once
from ..utils.timing import count, section
from .net_ops import compute_dtype


def _round_up(x, m):
    return ((x + m - 1) // m) * m


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
        self.dirty = np.zeros(buf, dtype=bool)

        self.poses = se3_identity((buf,), device=dev)
        self.disps = torch.ones(buf, h8, w8, device=dev)
        self.disps_sens = torch.zeros(buf, h8, w8, device=dev)
        self.disps_up = None        # [buf, ht, wd], allocated by the first upsample
        self.intrinsics = torch.zeros(buf, 4, device=dev)
        self.damping = torch.full((buf, h8, w8), 1e-6, device=dev)

        # the networks' features and states in the compute dtype; poses,
        # disparities and intrinsics stay fp32
        fdt = compute_dtype(config.compute_dtype)
        c = 2 if config.stereo else 1
        self.fmaps = torch.zeros(buf, c, h8, w8, 128, dtype=fdt, device=dev)
        self.nets = torch.zeros(buf, h8, w8, 128, dtype=fdt, device=dev)
        self.inps = torch.zeros(buf, h8, w8, 128, dtype=fdt, device=dev)

    def append(self, tstamp, image, pose, disp, depth, intrinsics, fmap, net=None, inp=None):
        """Add a keyframe at slot ``counter``.

        image [ht, wd, 3] uint8 (host) or None; pose [7] or None; disp a
        scalar or [h8, w8] or None; depth a full-resolution [ht, wd] depth
        map or None; fmap [c, h8, w8, 128] (one camera or two); net/inp
        [h8, w8, 128].
        """
        ix = self.counter
        self.set_slot(ix, tstamp, image, pose, disp, depth, intrinsics, fmap, net, inp)
        self.counter = ix + 1
        count("keyframes")

    def set_slot(self, ix, tstamp, image, pose, disp, depth, intrinsics, fmap, net=None,
                 inp=None):
        """Write slot ix in place (reference depth_video.py:56-114).

        A depth map is sampled at every 8th pixel from (3, 3), moved to the
        device in one copy and stored as the disparity 1 / depth where the
        depth is positive, else 0.  Mono features fill both cameras of a
        stereo buffer; a mono buffer keeps the left camera of stereo ones.
        """
        self.tstamp[ix] = tstamp
        if image is not None:
            self.images[ix] = np.asarray(image, dtype=np.uint8)
        self.dirty[ix] = True
        if pose is not None:
            self.poses[ix] = torch.as_tensor(pose, dtype=torch.float32, device=self.device)
        if disp is not None:
            self.disps[ix] = torch.as_tensor(disp, dtype=torch.float32, device=self.device)
        if depth is not None:
            with section("upload"):
                depth = torch.as_tensor(depth)[3::8, 3::8].to(self.device, torch.float32)
            self.disps_sens[ix] = torch.where(depth > 0, 1.0 / depth.clamp_min(1e-8), 0.0)
        if intrinsics is not None:
            self.intrinsics[ix] = torch.as_tensor(intrinsics, dtype=torch.float32,
                                                  device=self.device)
        if fmap is not None:
            self.fmaps[ix] = fmap[: self.fmaps.shape[1]]   # a one-camera fmap broadcasts
        if net is not None:
            self.nets[ix] = net
        if inp is not None:
            self.inps[ix] = inp

    def remove_keyframe(self, ix):
        """Copy slot ix+1 down into ix (reference factor_graph.py:165-178)."""
        self.tstamp[ix] = self.tstamp[ix + 1]
        self.images[ix] = self.images[ix + 1]
        for name in ("poses", "disps", "disps_sens", "intrinsics", "fmaps", "nets",
                     "inps", "damping"):
            buf = getattr(self, name)
            buf[ix] = buf[ix + 1]

    def normalize(self):
        """Mono gauge fix: scale by the mean disparity (reference depth_video.py:140-147)."""
        t = self.counter
        s = self.disps[:t].mean()
        self.disps[:t] /= s
        self.poses[:t, :3] *= s
        self.dirty[:t] = True

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

    def ba(self, target, weight, ii, jj, t0, t1, iterations=2, lm=1e-4, ep=0.1):
        """Windowed dense BA over the free frames [t0, t1) (mirror of video.py:218-290).

        target/weight [N, h8, w8, 2] on the device (N = the edge count);
        ii/jj global edge indices (host); damping 0.2 * damping + eps.  The
        window, edge count and Schur degree are padded to buckets as in the
        JAX package.  A window that ``_resolved_ba_shards`` shards runs
        through the keyframe-sharded ``parallel.dist_ba_solve``.
        """
        with section("video.ba"):
            self._ba(target, weight, ii, jj, t0, t1, iterations, lm, ep)

    def _ba(self, target, weight, ii, jj, t0, t1, iterations, lm, ep):
        cfg = self.cfg
        ii, jj = np.asarray(ii, np.int64), np.asarray(jj, np.int64)
        n = len(ii)
        m0 = int(min(ii.min(), jj.min(), t0))
        MW = _round_up(t1 - m0, cfg.window_bucket)
        m0 = max(0, t1 - MW)
        MW = t1 - m0 if m0 == 0 else MW
        MW = _round_up(MW, cfg.window_bucket)

        n_pad = _round_up(n, cfg.edge_bucket)
        ii_l = np.zeros(n_pad, np.int64)
        jj_l = np.zeros(n_pad, np.int64)
        ii_l[:n] = ii - m0
        jj_l[:n] = jj - m0
        pad = target.new_zeros(n_pad - n, self.h8, self.w8, 2)
        be, bm = native.bucket_tables(ii_l[:n], MW)
        free = np.zeros(MW, bool)
        free[t0 - m0: t1 - m0] = True

        sl = slice(m0, m0 + MW)
        eta = 0.2 * self.damping[sl] + cfg.damping_eps
        dev = self.device
        shards = self._resolved_ba_shards(MW, motion_only=False)
        if shards > 1:
            poses, disps = self._ba_sharded(sl, MW, ii_l[:n], jj_l[:n], target, weight, eta,
                                            free, iterations, lm, ep, shards)
        else:
            poses, disps = ba_iterations(
                self.poses[sl], self.disps[sl], self.intrinsics[0], self.disps_sens[sl],
                torch.cat([target, pad], 0), torch.cat([weight, pad], 0), eta,
                torch.as_tensor(ii_l, device=dev), torch.as_tensor(jj_l, device=dev),
                torch.as_tensor(free, device=dev),
                torch.as_tensor(be, dtype=torch.int64, device=dev),
                torch.as_tensor(bm, device=dev), iterations=iterations, lm=lm, ep=ep,
                alpha=cfg.rgbd_alpha, min_depth=cfg.min_depth)
        self.poses[sl] = poses
        self.disps[sl] = disps.clamp_min(0.001)   # reference depth_video.py:204

    def _resolved_ba_shards(self, MW, motion_only):
        """cfg.ba_shards with -1 = auto, by the JAX package's rules: auto
        shards a global-BA window of 128 frames or more over every local
        card (``torch.cuda.device_count()``; the CPU counts as one device, so
        auto never shards there); frontend-sized windows and motion-only
        solves stay unsharded.  A decline other than "window too small /
        motion-only" is logged once."""
        s = self.cfg.ba_shards
        if s == -1:
            n = local_device_count(self.device)
            if n > 1 and not motion_only and MW >= 128:
                if MW >= n:
                    return n
                log_once(f"ba_auto_shard_decline_{MW}_{n}",
                         f"auto BA sharding declined: window MW={MW} < {n} devices")
            return 0
        if s > 1 and not motion_only:
            if MW >= s:
                return s
            log_once(f"ba_shard_decline_{MW}_{s}",
                     f"BA sharding declined: window MW={MW} < ba_shards={s}")
        return 0

    def _ba_sharded(self, sl, MW, ii_l, jj_l, target, weight, eta, free, iterations, lm, ep,
                    shards):
        """Keyframe-sharded BA (parallel/dist_ba.py): shard k on card k mod
        the card count (every shard on this device with one card), depth
        buckets and their edges shard-local, only the pose system
        exchanged."""
        cfg = self.cfg
        mesh = getattr(self, "_kf_mesh", None)
        if mesh is None or mesh.size != shards:
            mesh = self._kf_mesh = make_mesh((shards,), ("kf",), devices=local_devices(self.device))
        ii_s, jj_s, tgt_s, wgt_s, be_s, bm_s, k0_s, rlen_s = partition_edges(
            ii_l, jj_l, target, weight, MW, shards, edge_bucket=cfg.edge_bucket)
        return dist_ba_solve(
            mesh, self.poses[sl], self.disps[sl], self.intrinsics[0], self.disps_sens[sl],
            tgt_s, wgt_s, eta, ii_s, jj_s, free, be_s, bm_s, k0_s, rlen_s,
            iterations=iterations, lm=lm, ep=ep, alpha=cfg.rgbd_alpha,
            min_depth=cfg.min_depth, exchange=resolve_exchange(device=self.device))

    def upsample(self, ix, mask):
        """8x upsample the disparities of slots ix [n] (long tensor) with the
        masks [n, h8, w8, 576] into disps_up, allocated on first use
        (reference depth_video.py:134-138)."""
        if self.disps_up is None:
            self.disps_up = torch.zeros(self.cfg.buffer, self.ht, self.wd, device=self.device)
        self.disps_up[ix] = cvx_upsample(self.disps[ix][..., None], mask.float())[..., 0]

    def state_dict(self):
        """The keyframes [0, counter) as fp32 numpy (reference droid.py:92-106)."""
        t = self.counter
        return {
            "tstamps": self.tstamp[:t].copy(),
            "images": self.images[:t].copy(),
            **{k: getattr(self, k)[:t].float().cpu().numpy()      # fp32, as the JAX package
               for k in ("poses", "disps", "disps_sens", "intrinsics", "fmaps", "nets", "inps")},
        }

    def load_state_dict(self, state, offset=0):
        """Write a saved session (``state_dict``'s keys, as either engine's
        reconstruction.npz holds them) into slots [offset, offset + t)
        (reference loop_detect.py:226-240 Give_Data).  The features are cast
        to the buffer's compute dtype (round to nearest even for bf16); a
        one-camera fmaps fills camera 0 only; ``disps_sens`` is optional."""
        t = len(state["tstamps"])
        sl = slice(offset, offset + t)
        self.tstamp[sl] = state["tstamps"]
        self.images[sl] = state["images"]
        for k in ("poses", "disps", "disps_sens", "intrinsics", "fmaps", "nets", "inps"):
            if k == "disps_sens" and k not in state:
                continue
            buf = getattr(self, k)
            val = torch.tensor(np.asarray(state[k], np.float32), device=self.device)
            val = val.to(buf.dtype)
            if k == "fmaps":
                buf[sl, :val.shape[1]] = val
            else:
                buf[sl] = val
        self.counter = max(self.counter, offset + t)
