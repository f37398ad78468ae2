"""DROID-SLAM's tracking and global refinement in plain PyTorch and numpy,
fp32: the keyframe video, the motion filter, the factor graph with its
update rounds and dense BA, the frontend, the backend and the trajectory
filler.

A frozen copy of the plain semantics of the port's ``engine/`` (itself a
mirror of the upstream ``droid_slam/``), with every kernel replaced by its
plain counterpart: the full correlation pyramid for the windowed cache
(K4/K5) and for K2/K3, the einsum blocks for K1, numpy for the graph
library.  It keeps the program's windows and buckets where they change
the arithmetic (the BA window bounds which frames a depth prior reaches),
and leaves out what the benchmark's configurations do not run: bf16,
upsampling, the multisession variants and sharding.

``RefDroid.load_state`` puts a state of the program (poses, disparities,
damping, the factor graph) into the reference so that it can follow one
step from there; features, sensor disparities and intrinsics it always
works out itself from the raw inputs.
"""
import numpy as np
import torch

from . import corr
from .ba import ba_iterations, bucket_tables
from .geom import coords_grid, frame_distance, neighbourhood_graph, projective_transform
from .lie import se3_exp, se3_identity, se3_inv, se3_log, se3_mul


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def dedup_edges(ii, jj, ex_i, ex_j):
    eset = set(zip(np.asarray(ex_i).tolist(), np.asarray(ex_j).tolist()))
    return np.array([(i, j) not in eset for i, j in zip(ii.tolist(), jj.tolist())], bool)


def proximity_select(d, t0, t1, t, rad, nms, thresh, max_factors, ex_i, ex_j, stereo):
    """Greedy edge selection by frame distance with non-maximum suppression
    (upstream factor_graph.py:315-379)."""
    ii, jj = np.meshgrid(np.arange(t0, t), np.arange(t1, t), indexing="ij")
    d = np.array(d, np.float64).reshape(-1)
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    d[ii - rad < jj] = np.inf
    d[d > 100] = np.inf

    def suppress(i, j):
        for di in range(-nms, nms + 1):
            for dj in range(-nms, nms + 1):
                if abs(di) + abs(dj) <= max(min(abs(i - j) - 2, nms), 0):
                    i1, j1 = i + di, j + dj
                    if t0 <= i1 < t and t1 <= j1 < t:
                        d[(i1 - t0) * (t - t1) + (j1 - t1)] = np.inf

    for i, j in zip(np.asarray(ex_i).tolist(), np.asarray(ex_j).tolist()):
        suppress(i, j)
    es = []
    for i in range(t0, t):
        if stereo:
            es.append((i, i))
            if t1 <= i:
                d[(i - t0) * (t - t1) + (i - t1)] = np.inf
        for j in range(max(i - rad - 1, 0), i):
            es += [(i, j), (j, i)]
            if t1 <= j < t:
                d[(i - t0) * (t - t1) + (j - t1)] = np.inf
    for k in np.argsort(d, kind="stable"):
        if d[k] > thresh or (max_factors > 0 and len(es) > max_factors):
            break
        i, j = int(ii[k]), int(jj[k])
        es += [(i, j), (j, i)]
        suppress(i, j)
    es = np.asarray(es, np.int64).reshape(-1, 2)
    return es[:, 0], es[:, 1]


class Video:
    def __init__(self, cfg, device):
        self.cfg, self.device = cfg, device
        ht, wd = cfg["image_size"]
        self.h8, self.w8 = h8, w8 = ht // 8, wd // 8
        buf = cfg["buffer"]
        self.stereo = cfg["stereo"]
        self.counter = 0
        self.tstamp = np.zeros(buf, np.float64)
        self.poses = se3_identity((buf,), device=device)
        self.disps = torch.ones(buf, h8, w8, device=device)
        self.disps_sens = torch.zeros(buf, h8, w8, device=device)
        self.intrinsics = torch.zeros(buf, 4, device=device)
        self.damping = torch.full((buf, h8, w8), 1e-6, device=device)
        self.fmaps = torch.zeros(buf, 2 if self.stereo else 1, h8, w8, 128, device=device)
        self.nets = torch.zeros(buf, h8, w8, 128, device=device)
        self.inps = torch.zeros(buf, h8, w8, 128, device=device)

    def set_slot(self, ix, tstamp, pose, disp, depth, intrinsics, fmap, net=None, inp=None):
        self.tstamp[ix] = tstamp
        if pose is not None:
            self.poses[ix] = pose
        if disp is not None:
            self.disps[ix] = disp
        if depth is not None:
            d = torch.as_tensor(depth)[3::8, 3::8].to(self.device, torch.float32)
            self.disps_sens[ix] = torch.where(d > 0, 1.0 / d.clamp_min(1e-8), 0.0)
        if intrinsics is not None:
            self.intrinsics[ix] = torch.as_tensor(intrinsics, dtype=torch.float32,
                                                  device=self.device)
        if fmap is not None:
            self.fmaps[ix] = fmap[: self.fmaps.shape[1]]
        if net is not None:
            self.nets[ix] = net
        if inp is not None:
            self.inps[ix] = inp

    def append(self, *args):
        self.set_slot(self.counter, *args)
        self.counter += 1

    def remove_keyframe(self, ix):
        self.tstamp[ix] = self.tstamp[ix + 1]
        for name in ("poses", "disps", "disps_sens", "intrinsics", "fmaps", "nets", "inps",
                     "damping"):
            buf = getattr(self, name)
            buf[ix] = buf[ix + 1]

    def normalize(self):
        t = self.counter
        s = self.disps[:t].mean()
        self.disps[:t] /= s
        self.poses[:t, :3] *= s

    def _t(self, x):
        return torch.as_tensor(np.asarray(x, np.int64).reshape(-1), device=self.device)

    def reproject(self, ii, jj):
        return projective_transform(self.poses[None], self.disps[None], self.intrinsics[None],
                                    self._t(ii), self._t(jj))

    def distance(self, ii, jj, beta):
        ii, jj = np.asarray(ii).reshape(-1), np.asarray(jj).reshape(-1)
        n = len(ii)
        d = frame_distance(self.poses, self.disps, self.intrinsics[0],
                           self._t(np.concatenate([ii, jj])),
                           self._t(np.concatenate([jj, ii])), beta=beta).cpu().numpy()
        return 0.5 * (d[:n] + d[n:])

    def distance_matrix(self, t0, t1, t, beta):
        ii, jj = np.meshgrid(np.arange(t0, t), np.arange(t1, t), indexing="ij")
        return self.distance(ii, jj, beta).reshape(t - t0, t - t1)

    def ba(self, target, weight, ii, jj, t0, t1, iterations, lm, ep):
        """Dense BA over the free frames [t0, t1), windowed as the program does."""
        cfg = self.cfg
        n = len(ii)
        m0 = int(min(ii.min(), jj.min(), t0))
        MW = _round_up(t1 - m0, cfg["window_bucket"])
        m0 = max(0, t1 - MW)
        MW = _round_up(t1 - m0 if m0 == 0 else MW, cfg["window_bucket"])
        be, bm = bucket_tables(ii - m0, MW)
        free = np.zeros(MW, bool)
        free[t0 - m0: t1 - m0] = True
        sl = slice(m0, m0 + MW)
        dev = self.device
        poses, disps = ba_iterations(
            self.poses[sl], self.disps[sl], self.intrinsics[0], self.disps_sens[sl], target,
            weight, 0.2 * self.damping[sl] + cfg["damping_eps"], self._t(ii - m0),
            self._t(jj - m0), torch.as_tensor(free, device=dev), self._t(be).reshape(be.shape),
            torch.as_tensor(bm, device=dev), iterations=iterations, lm=lm, ep=ep,
            alpha=cfg["rgbd_alpha"], min_depth=cfg["min_depth"])
        self.poses[sl] = poses
        self.disps[sl] = disps.clamp_min(0.001)


class FactorGraph:
    def __init__(self, video, update, max_factors=-1):
        self.video, self.update, self.max_factors = video, update, max_factors
        self.cfg = video.cfg
        dev, h8, w8 = video.device, video.h8, video.w8
        z2 = torch.zeros(0, h8, w8, 2, device=dev)
        self.ii = self.jj = self.age = np.zeros(0, np.int64)
        self.net = torch.zeros(0, h8, w8, 128, device=dev)
        self.target, self.weight = z2, z2
        self.ii_inac = self.jj_inac = np.zeros(0, np.int64)
        self.target_inac, self.weight_inac = z2, z2
        self.ii_bad = self.jj_bad = np.zeros(0, np.int64)

    def _t(self, x):
        return self.video._t(x)

    def add_factors(self, ii, jj, remove=False):
        ii, jj = np.asarray(ii, np.int64).reshape(-1), np.asarray(jj, np.int64).reshape(-1)
        keep = dedup_edges(ii, jj, np.concatenate([self.ii, self.ii_inac]),
                           np.concatenate([self.jj, self.jj_inac]))
        ii, jj = ii[keep], jj[keep]
        if len(ii) == 0:
            return
        if (self.max_factors > 0 and len(self.ii) + len(ii) > self.max_factors
                and len(self.ii) > 0 and remove):
            ix = np.argsort(self.age)[::-1]
            mask = np.zeros(len(self.ii), bool)
            mask[ix[:len(self.ii) + len(ii) - self.max_factors]] = True
            self.rm_factors(mask, store=True)
        target = self.video.reproject(ii, jj)[0][0]
        self.ii = np.concatenate([self.ii, ii])
        self.jj = np.concatenate([self.jj, jj])
        self.age = np.concatenate([self.age, np.zeros(len(ii), np.int64)])
        self.net = torch.cat([self.net, self.video.nets[self._t(ii)]], 0)
        self.target = torch.cat([self.target, target], 0)
        self.weight = torch.cat([self.weight, torch.zeros_like(target)], 0)

    def rm_factors(self, mask, store=False):
        mask = np.asarray(mask, bool)
        if store and mask.any():
            sel = self._t(np.nonzero(mask)[0])
            self.ii_inac = np.concatenate([self.ii_inac, self.ii[mask]])
            self.jj_inac = np.concatenate([self.jj_inac, self.jj[mask]])
            self.target_inac = torch.cat([self.target_inac, self.target[sel]], 0)
            self.weight_inac = torch.cat([self.weight_inac, self.weight[sel]], 0)
        keep = ~mask
        kd = self._t(np.nonzero(keep)[0])
        self.ii, self.jj, self.age = self.ii[keep], self.jj[keep], self.age[keep]
        self.net, self.target, self.weight = self.net[kd], self.target[kd], self.weight[kd]

    def rm_keyframe(self, ix):
        self.video.remove_keyframe(ix)
        m = (self.ii_inac == ix) | (self.jj_inac == ix)
        self.ii_inac = np.where(self.ii_inac >= ix, self.ii_inac - 1, self.ii_inac)
        self.jj_inac = np.where(self.jj_inac >= ix, self.jj_inac - 1, self.jj_inac)
        if m.any():
            keep = self._t(np.nonzero(~m)[0])
            self.ii_inac, self.jj_inac = self.ii_inac[~m], self.jj_inac[~m]
            self.target_inac, self.weight_inac = self.target_inac[keep], self.weight_inac[keep]
        m = (self.ii == ix) | (self.jj == ix)
        self.ii = np.where(self.ii >= ix, self.ii - 1, self.ii)
        self.jj = np.where(self.jj >= ix, self.jj - 1, self.jj)
        self.rm_factors(m, store=False)

    def _features(self, ii, jj):
        """Source and target features per edge: a stereo self-edge takes the
        right camera of its frame."""
        v = self.video
        cams = self._t((ii == jj).astype(np.int64)) if v.stereo else 0
        return v.fmaps[self._t(ii), 0], v.fmaps[self._t(jj), cams]

    def _step(self, nets, inps, corr_e, coords1, target, kk, M, emask):
        """One update-operator step for a batch of edges."""
        h8, w8 = self.video.h8, self.video.w8
        coords0 = coords_grid(h8, w8, device=coords1.device)
        motn = torch.cat([coords1 - coords0, target - coords1], -1).clamp(-64.0, 64.0)
        return self.update(nets[None], inps[None], corr_e[None], motn[None], kk, M, emask)

    def update_fused(self, rounds, t0=None, t1=None, itrs=2, use_inactive=True, cull_pair=None,
                     motion_only=False):
        """``rounds`` x (update operator + dense BA) over the active edges,
        inactive edges inside the window joining the BA with their frozen
        target and weight; returns the cull pair's distance or None."""
        if len(self.ii) == 0 or rounds == 0:
            return None
        v, cfg, dev = self.video, self.cfg, self.video.device
        h8, w8 = v.h8, v.w8
        n = len(self.ii)
        if t0 is None:
            t0 = max(1, int(self.ii.min()) + 1)
        if t1 is None:
            t1 = int(max(self.ii.max(), self.jj.max())) + 1
        if use_inactive and len(self.ii_inac):
            m = (self.ii_inac >= t0 - 3) & (self.jj_inac >= t0 - 3)
            ii_i, jj_i = self.ii_inac[m], self.jj_inac[m]
            sel = self._t(np.nonzero(m)[0])
            tgt_i, wgt_i = self.target_inac[sel], self.weight_inac[sel]
        else:
            ii_i = jj_i = np.zeros(0, np.int64)
            tgt_i = wgt_i = torch.zeros(0, h8, w8, 2, device=dev)
        lows = [int(self.ii.min()), int(self.jj.min()), t0]
        if len(ii_i):
            lows += [int(ii_i.min()), int(jj_i.min())]
        MW = _round_up(t1 - min(lows), cfg["window_bucket"])
        m0 = max(0, t1 - MW)
        if m0 == 0:
            MW = _round_up(t1, cfg["window_bucket"])
        ii_all = np.concatenate([ii_i, self.ii]) - m0
        jj_all = np.concatenate([jj_i, self.jj]) - m0
        be, bm = bucket_tables(ii_all, MW)
        free = np.zeros(MW, bool)
        free[t0 - m0: t1 - m0] = True
        has_edge = torch.zeros(MW, dtype=torch.bool, device=dev)
        has_edge[self._t(self.ii - m0)] = True
        win = slice(m0, m0 + MW)
        poses, disps, damping = v.poses[win], v.disps[win], v.damping[win]
        intr = v.intrinsics[0]
        ii_l, jj_l = self._t(self.ii - m0), self._t(self.jj - m0)
        f1, f2 = self._features(self.ii, self.jj)
        levels = [corr.pyramid(f1[e:e + 16], f2[e:e + 16]) for e in range(0, n, 16)]
        nets, inps, target = self.net, v.inps[self._t(self.ii)], self.target
        emask = torch.ones(n, device=dev)
        weight = torch.zeros_like(target)
        for _ in range(rounds):
            coords1 = projective_transform(poses[None], disps[None], intr.expand(MW, 4)[None],
                                           ii_l, jj_l)[0][0]
            c = coords1.reshape(n, h8 * w8, 2)
            corr_e = torch.cat([corr.lookup(lv, c[16 * k:16 * k + 16])
                                for k, lv in enumerate(levels)], 0).reshape(n, h8, w8, -1)
            nets, delta, weight, eta, _ = self._step(nets, inps, corr_e, coords1, target, ii_l,
                                                     MW, emask)
            nets, target, weight = nets[0], coords1 + delta[0], weight[0]
            damping = torch.where(has_edge[:, None, None], eta[0], damping)
            poses, disps = ba_iterations(
                poses, disps, intr, v.disps_sens[win], torch.cat([tgt_i, target], 0),
                torch.cat([wgt_i, weight], 0), 0.2 * damping + cfg["damping_eps"],
                self._t(ii_all), self._t(jj_all), torch.as_tensor(free, device=dev),
                self._t(be).reshape(be.shape), torch.as_tensor(bm, device=dev),
                iterations=itrs, lm=cfg["frontend_lm"], ep=cfg["frontend_ep"],
                motion_only=motion_only, alpha=cfg["rgbd_alpha"], min_depth=cfg["min_depth"])
            disps = disps.clamp_min(0.001)
        d_cull = None
        if cull_pair is not None:
            cij = self._t([cull_pair[0] - m0, cull_pair[1] - m0])
            d2 = frame_distance(poses, disps, intr, cij, cij.flip(0), beta=cfg["beta"],
                                min_depth=cfg["min_depth"])
            d_cull = float(0.5 * (d2[0] + d2[1]))
        v.poses[win], v.disps[win], v.damping[win] = poses, disps, damping
        self.net, self.target, self.weight = nets, target, weight
        self.age += rounds
        return d_cull

    def update_lowmem(self, steps, itrs=2):
        """Each step refreshes every edge against the same poses, 8 source
        frames at a time, then runs one dense BA over the whole video."""
        v, cfg = self.video, self.cfg
        t = v.counter
        if len(self.ii) == 0:
            return
        h8, w8 = v.h8, v.w8
        chunks = [np.nonzero((self.ii >= c) & (self.ii < c + 8))[0]
                  for c in range(0, int(self.ii.max()) + 1, 8)]
        for _ in range(steps):
            net = torch.empty_like(self.net)
            target = torch.empty_like(self.target)
            weight = torch.empty_like(self.weight)
            damping = v.damping[:t].clone()
            for c, sel in enumerate(chunks):
                if len(sel) == 0:
                    continue
                ii, jj = self.ii[sel], self.jj[sel]
                st = self._t(sel)
                coords1 = v.reproject(ii, jj)[0][0]
                f1, f2 = self._features(ii, jj)
                corr_e = corr.correlate(f1, f2, coords1.reshape(len(sel), h8 * w8, 2))
                out = self._step(self.net[st], v.inps[self._t(ii)],
                                 corr_e.reshape(len(sel), h8, w8, -1), coords1, self.target[st],
                                 self._t(ii - 8 * c), 8, torch.ones(len(sel), device=v.device))
                net[st], target[st], weight[st] = out[0][0], coords1 + out[1][0], out[2][0]
                frames = np.unique(ii)
                damping[self._t(frames)] = out[3][0][self._t(frames - 8 * c)]
            self.net, self.target, self.weight = net, target, weight
            v.damping[:t] = damping
            v.ba(self.target, self.weight, self.ii, self.jj, 1, t, iterations=itrs,
                 lm=cfg["backend_lm"], ep=cfg["backend_ep"])

    def add_neighborhood_factors(self, t0, t1, r=3):
        ii, jj = neighbourhood_graph(t1 - t0, r, c=1 if self.video.stereo else 0)
        self.add_factors(ii + t0, jj + t0)

    def add_proximity_factors(self, t0=0, t1=0, rad=2, nms=2, beta=0.25, thresh=16.0,
                              remove=False):
        t = self.video.counter
        if t - t0 <= 0 or t - t1 <= 0:
            return
        d = self.video.distance_matrix(t0, t1, t, beta)
        ii, jj = proximity_select(
            d, t0, t1, t, rad, nms, thresh, self.max_factors,
            np.concatenate([self.ii, self.ii_bad, self.ii_inac]),
            np.concatenate([self.jj, self.jj_bad, self.jj_inac]), self.video.stereo)
        if len(ii):
            self.add_factors(ii, jj, remove)


class MotionFilter:
    """Admits a frame when one update-operator step against the last
    keyframe moves its pixels by more than ``thresh`` on average."""

    def __init__(self, nets, video, thresh):
        self.nets, self.video, self.thresh = nets, video, thresh
        self.fmap = self.hidden = self.inp = None

    def track(self, tstamp, image, depth, intrinsics):
        v = self.video
        dev = v.device
        image = np.asarray(image)
        imgs = torch.as_tensor((image if image.ndim == 4 else image[None]).astype(np.float32),
                               device=dev)
        intr = torch.as_tensor(np.asarray(intrinsics, np.float32), device=dev) / 8.0
        gmap = self.nets.features(imgs)
        if v.counter == 0:
            net, inp = self.nets.context(imgs[:1])
            self.hidden, self.inp, self.fmap = net[0], inp[0], gmap
            v.append(tstamp, se3_identity(device=dev), 1.0, depth, intr, gmap, net[0], inp[0])
            return
        h8, w8 = gmap.shape[1:3]
        coords0 = coords_grid(h8, w8, device=dev).reshape(1, h8 * w8, 2)
        corr_e = corr.correlate(self.fmap[:1], gmap[:1], coords0).reshape(1, 1, h8, w8, -1)
        _, delta, _ = self.nets.update(self.hidden[None, None], self.inp[None, None], corr_e)
        if float(delta[0, 0].norm(dim=-1).mean()) > self.thresh:
            net, inp = self.nets.context(imgs[:1])
            self.hidden, self.inp, self.fmap = net[0], inp[0], gmap
            v.append(tstamp, None, None, depth, intr, gmap, net[0], inp[0])


class Frontend:
    def __init__(self, update, video, cfg):
        self.video, self.cfg = video, cfg
        self.graph = FactorGraph(video, update, max_factors=cfg["max_factors"])
        self.t0 = self.t1 = 0
        self.is_initialized = False

    def _update(self):
        cfg, v, g = self.cfg, self.video, self.graph
        self.t1 += 1
        if len(g.ii) > 0:
            g.rm_factors(g.age > cfg["max_age"], store=True)
        g.add_proximity_factors(self.t1 - 5, max(self.t1 - cfg["frontend_window"], 0),
                                rad=cfg["frontend_radius"], nms=cfg["frontend_nms"],
                                thresh=cfg["frontend_thresh"], beta=cfg["beta"], remove=True)
        dsens = v.disps_sens[self.t1 - 1]
        v.disps[self.t1 - 1] = torch.where(dsens > 0, dsens, v.disps[self.t1 - 1])
        d_cull = g.update_fused(cfg["iters1"], cull_pair=(self.t1 - 3, self.t1 - 2))
        if d_cull is None:
            d_cull = v.distance([self.t1 - 3], [self.t1 - 2], cfg["beta"])[0]
        if d_cull < cfg["keyframe_thresh"]:
            g.rm_keyframe(self.t1 - 2)
            v.counter -= 1
            self.t1 -= 1
        else:
            g.update_fused(cfg["iters2"])
        v.poses[self.t1] = v.poses[self.t1 - 1]
        v.disps[self.t1] = v.disps[self.t1 - 1].mean()

    def _initialize(self):
        cfg, v, g = self.cfg, self.video, self.graph
        self.t0, self.t1 = 0, v.counter
        g.add_neighborhood_factors(self.t0, self.t1, r=3)
        g.update_fused(cfg["init_iters"], t0=1)
        g.add_proximity_factors(0, 0, rad=2, nms=2, thresh=cfg["frontend_thresh"], remove=False)
        g.update_fused(cfg["init_iters"], t0=1)
        v.poses[self.t1] = v.poses[self.t1 - 1]
        v.disps[self.t1] = v.disps[self.t1 - 4: self.t1].mean()
        self.is_initialized = True
        g.rm_factors(g.ii < cfg["warmup"] - 4, store=True)

    def __call__(self):
        if not self.is_initialized and self.video.counter == self.cfg["warmup"]:
            self._initialize()
        elif self.is_initialized and self.t1 < self.video.counter:
            self._update()


class RefDroid:
    """track and terminate_eva of DROID-SLAM on a configuration dict (the
    keys of the program's DroidConfig) with the networks ``nets``."""

    def __init__(self, cfg, nets, device):
        if cfg.get("upsample") or cfg.get("compute_dtype", "float32") != "float32":
            raise ValueError("the reference runs fp32 without upsampling")
        self.cfg, self.nets = cfg, nets
        self.video = Video(cfg, device)
        self.filterx = MotionFilter(nets, self.video, cfg["filter_thresh"])
        self.frontend = Frontend(self._update, self.video, cfg)

    def _update(self, net, inp, corr_e, motn, kk, M, emask):
        return self.nets.update(net, inp, corr_e, motn, kk, M, emask)

    @torch.no_grad()
    def track(self, tstamp, image, depth=None, intrinsics=None):
        self.filterx.track(tstamp, image, depth, intrinsics)
        self.frontend()

    @torch.no_grad()
    def backend(self, steps):
        v, cfg = self.video, self.cfg
        t = v.counter
        if t < 2:
            return
        if not v.stereo and not bool((v.disps_sens[:t] > 0).any()):
            v.normalize()
        graph = FactorGraph(v, self._update, max_factors=16 * t)
        graph.add_proximity_factors(rad=cfg["backend_radius"], nms=cfg["backend_nms"],
                                    thresh=cfg["backend_thresh"], beta=cfg["beta"])
        graph.update_lowmem(steps=steps)

    @torch.no_grad()
    def fill(self, stream):
        """Poses [T, 7] of every (tstamp, image, intrinsics) of ``stream``:
        16 frames at a time, interpolated between the bracketing keyframes
        and refined by 6 motion-only rounds against them."""
        out, chunk = [], []
        for item in stream:
            chunk.append(item)
            if len(chunk) == 16:
                out.append(self._fill(chunk))
                chunk = []
        if chunk:
            out.append(self._fill(chunk))
        return np.concatenate(out, 0)

    def _fill(self, chunk):
        v = self.video
        dev = v.device
        N, M = v.counter, len(chunk)
        tstamps = [c[0] for c in chunk]
        ts = v.tstamp[:N]
        t0 = np.clip(np.array([np.sum(ts <= t) - 1 for t in tstamps]), 0, N - 1)
        t1 = np.where(t0 < N - 1, t0 + 1, t0)
        Ps = v.poses[:N]
        i0, i1 = v._t(t0), v._t(t1)
        dt = torch.as_tensor(ts[t1] - ts[t0] + 1e-3, dtype=torch.float32, device=dev)[:, None]
        vlog = se3_log(se3_mul(Ps[i1], se3_inv(Ps[i0]))) / dt
        w = vlog * torch.as_tensor(np.asarray(tstamps, np.float64) - ts[t0],
                                   dtype=torch.float32, device=dev)[:, None]
        Gs = se3_mul(se3_exp(w), Ps[i0])
        imgs = np.stack([np.asarray(c[1]) if np.asarray(c[1]).ndim == 4
                         else np.asarray(c[1])[None] for c in chunk])
        ncam = imgs.shape[1]
        fmaps = self.nets.features(torch.as_tensor(imgs.reshape((-1,) + imgs.shape[2:]),
                                                   dtype=torch.float32, device=dev))
        fmaps = fmaps.reshape((M, ncam) + fmaps.shape[1:])
        for m in range(M):
            v.set_slot(N + m, tstamps[m], Gs[m], None, None,
                       torch.as_tensor(np.asarray(chunk[m][2], np.float32)) / 8.0, fmaps[m])
        v.counter = N + M
        graph = FactorGraph(v, self._update)
        graph.add_factors(t0, np.arange(N, N + M))
        graph.add_factors(t1, np.arange(N, N + M))
        graph.update_fused(6, t0=N, t1=N + M, use_inactive=False, motion_only=True)
        out = v.poses[N: N + M].cpu().numpy()
        v.counter = N
        return out

    def terminate_eva(self, stream):
        """The backend's two runs, then the filler; the camera trajectory
        [T, 7] (the inverted world-to-camera poses)."""
        self.backend(self.cfg["backend_steps_first"])
        self.backend(self.cfg["backend_steps_second"])
        with torch.no_grad():
            return se3_inv(torch.as_tensor(self.fill(stream))).numpy()

    @torch.no_grad()
    def encode(self, images):
        """fmaps [F, c, h8, w8, 128], nets, inps [F, h8, w8, 128] of frames
        [F, (c,) H, W, 3], a few frames at a time."""
        fm, ne, ip = [], [], []
        for k in range(0, len(images), 4):
            x = np.asarray(images[k:k + 4])
            if x.ndim == 4:
                x = x[:, None]
            imgs = torch.as_tensor(x.astype(np.float32), device=self.video.device)
            f = self.nets.features(imgs.reshape((-1,) + imgs.shape[2:]))
            fm.append(f.reshape(imgs.shape[:2] + f.shape[1:]))
            n, i = self.nets.context(imgs[:, 0])
            ne.append(n)
            ip.append(i)
        return torch.cat(fm), torch.cat(ne), torch.cat(ip)

    def load_frames(self, tstamps, images, depths, intrinsics, encoded=None):
        """Slots 0 .. F-1 from raw inputs: features (``encode``'s, or
        ``encoded`` when the caller already has them), sensor disparities,
        intrinsics and timestamps, as the motion filter writes them."""
        v = self.video
        fm, ne, ip = self.encode(images) if encoded is None else encoded
        F_ = len(images)
        v.fmaps[:F_] = fm[:F_, :v.fmaps.shape[1]]
        v.nets[:F_], v.inps[:F_] = ne[:F_], ip[:F_]
        for k in range(F_):
            v.set_slot(k, tstamps[k], None, None, None if depths is None else depths[k],
                       np.asarray(intrinsics[k], np.float32) / 8.0, None)
        self.filterx.hidden, self.filterx.inp, self.filterx.fmap = ne[F_ - 1], ip[F_ - 1], fm[F_ - 1]

    def load_state(self, state):
        """The program's evolving state: ``counter``, poses/disps/damping of
        slots [0, len) and, where given, the frontend's counters and its
        factor graph."""
        v, g, dev = self.video, self.frontend.graph, self.video.device
        v.counter = state["counter"]
        n = len(state["poses"])
        for k in ("poses", "disps", "damping"):
            getattr(v, k)[:n] = torch.as_tensor(state[k], device=dev)
        if "ii" not in state:
            return
        f = self.frontend
        f.t0, f.t1, f.is_initialized = state["t0"], state["t1"], state["is_initialized"]
        for k in ("ii", "jj", "age", "ii_inac", "jj_inac", "ii_bad", "jj_bad"):
            setattr(g, k, np.asarray(state[k], np.int64).copy())
        for k in ("net", "target", "weight", "target_inac", "weight_inac"):
            setattr(g, k, torch.as_tensor(state[k], device=dev).float())
