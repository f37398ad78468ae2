"""Covisibility factor graph (mirror of engine/factor_graph.py).

Host bookkeeping (add / remove) runs in numpy; the dedup, the proximity
selection and the Schur bucket tables call the port's C++ graph library
(``native``).  ``update_fused`` (frontend and trajectory filler) pads the edges,
cuts the frame window and calls ``fused_rounds``: K rounds of
{reproject -> correlation lookup -> ConvGRU update + GraphAgg -> dense BA}
as a Python loop, on the JAX package's default TPU path: each call caches
every pixel's per-level correlation window around the first round's coords
(K4), and each round looks the windows up (K5) while the drift rule holds,
else takes the exact full lookup (K2, built at most once per call, then
K3).  ``probe_quality`` (the multisession frontend's gate) runs one
update-operator step on the exact route, K2 + K3.  ``update_lowmem``
(backend) refreshes every edge chunk by chunk with
K2 + K3 and runs one global BA per step.  With ``upsample`` each call
writes the full-resolution disparities of the frames it updated into
``video.disps_up``: update_fused from its last round's upsampling mask,
update_lowmem from each chunk's.  Each BA iteration builds its
blocks once (K1).  Edge counts and BA windows are padded to buckets as in
the JAX package; padded edges add nothing.  In a stereo video a
self-edge (i, i) correlates frame i's left features with its right ones
(the JAX package's ``cams``).

Features and the update operator's state are in the compute dtype
(``video.fmaps.dtype``), and so are update_fused's window cache, fallback
levels and lookups; the backend's levels are fp32.  Delta, weight and eta
are cast to fp32 before the BA, which runs in fp32.
"""
import copy

import numpy as np
import torch

from .. import native
from ..ba.solver import ba_iterations
from ..geom import coords_grid, frame_distance, neighbourhood_graph, projective_transform
from ..ops.corr import level_sizes, window_drift_ok
from ..ops.cuda_corr import corr_build, corr_build_windows, corr_lookup, corr_lookup_windows
from ..parallel import local_device_count, local_devices
from ..utils.timing import clear_counters, count, count_sync, counters, section


def corr_rounds():
    """Rounds of update_fused that read the window cache (K5) and rounds that
    fell back to the full lookup (K2 + K3) since the last reset_corr_rounds():
    the tracer's ``corr_rounds`` counters."""
    c = counters()
    return {k: c.get("corr_rounds." + k, 0) for k in ("windowed", "fallback")}


def reset_corr_rounds():
    clear_counters("corr_rounds.")


def _round_up(x, m):
    return ((x + m - 1) // m) * m


class WindowedLookup:
    """The per-call correlation of update_fused: K4 once, then per round K5
    where the drift rule holds, else K2 (built lazily, once) and K3."""

    def __init__(self, f1, f2, coords_init):
        self.f1, self.f2 = f1, f2
        self.hw = tuple(f2.shape[1:3])
        self.sizes = level_sizes(*self.hw)
        with section("corr"):
            self.wins, self.bases = corr_build_windows(f1, f2, coords_init)
        self.levels = None

    def __call__(self, coords):
        with section("corr"):
            # the round's one host read: the fallback decision
            count_sync("drift")
            if bool(window_drift_ok(self.bases, coords, self.sizes)):
                count("corr_rounds.windowed")
                return corr_lookup_windows(self.wins, self.bases, coords, self.hw)
            count("corr_rounds.fallback")
            if self.levels is None:
                self.levels = corr_build(self.f1, self.f2)
            return corr_lookup(self.levels, coords)


def fused_rounds(update_apply, params, poses, disps, disps_sens, damping, intr, fmap1_e,
                 fmap2_e, nets, inps, target_a, ii_a, jj_a, kk, active_mask, has_edge, ii_all,
                 jj_all, target_inac, weight_inac, free_mask, bucket_edges, bucket_mask,
                 cull_ij=None, *, rounds, ba_iters, lm, ep, damping_eps, min_depth, beta,
                 motion_only=False, alpha=0.05):
    """``rounds`` x (update operator + dense BA) over one frame window: the
    counterpart of the JAX package's ``_fused_rounds``, with its inputs.

    Window-local: poses [MW, 7], disps/disps_sens/damping [MW, H, W],
    intr [4]; per active edge (padded): fmap1_e/fmap2_e [E, H, W, C] source
    and target features, nets/inps [E, H, W, 128], target_a [E, H, W, 2],
    ii_a/jj_a/kk [E] long, active_mask [E] (0 on padded edges); has_edge
    [MW] bool; for the BA, ii_all/jj_all over the inactive edges (frozen
    target_inac/weight_inac) then the active ones, free_mask [MW] bool and
    the bucket tables of schur_pairs(ii_all, MW); cull_ij an optional pair
    of local frames.

    Returns (poses, disps, damping, nets, target_a, weight_a, upmask of the
    last round [MW, H, W, 576], d_cull): d_cull is the pair's bidirectional
    flow distance on the final state as a 0-d tensor, or None.
    """
    MW = poses.shape[0]
    E = fmap1_e.shape[0]
    h8, w8 = disps.shape[-2:]
    intr_win = intr.expand(MW, 4)
    active = active_mask.to(torch.float32)
    amask = active[:, None, None, None]
    has_edge = has_edge[:, None, None]

    def reproject():
        return projective_transform(poses[None], disps[None], intr_win[None], ii_a, jj_a)[0][0]

    # the window cache around the first round's coords, once per call (K4)
    coords1 = reproject()
    lookup = WindowedLookup(fmap1_e, fmap2_e, coords1.reshape(E, h8 * w8, 2).contiguous())
    coords0 = coords_grid(h8, w8, device=poses.device)
    weight_a = torch.zeros_like(target_a)
    upmask = None

    for r in range(rounds):
        if r > 0:
            coords1 = reproject()
        motn = torch.cat([coords1 - coords0, target_a - coords1], -1).clamp(-64.0, 64.0)
        corr = lookup(coords1.reshape(E, h8 * w8, 2).contiguous())
        corr = corr.reshape(E, h8, w8, -1)

        # the active mask keeps padded edges out of GraphAgg's per-frame mean
        nets, delta, weight, eta, upmask = update_apply(
            params, nets[None], inps[None], corr[None], motn[None], kk, MW, active)
        nets = nets[0]
        target_a = coords1 + delta[0].float()
        weight_a = weight[0].float() * amask

        damping = torch.where(has_edge, eta[0].float(), damping)
        eta_ba = 0.2 * damping + damping_eps
        poses, disps = ba_iterations(
            poses, disps, intr, disps_sens, torch.cat([target_inac, target_a], 0),
            torch.cat([weight_inac, weight_a], 0), eta_ba, ii_all, jj_all, free_mask,
            bucket_edges, bucket_mask, iterations=ba_iters, lm=lm, ep=ep,
            motion_only=motion_only, alpha=alpha, min_depth=min_depth)
        disps = disps.clamp_min(0.001)

    d_cull = None
    if cull_ij is not None:
        d2 = frame_distance(poses, disps, intr, cull_ij, cull_ij.flip(0),
                            beta=beta, min_depth=min_depth)
        d_cull = 0.5 * (d2[0] + d2[1])
    return (poses, disps, damping, nets, target_a, weight_a,
            None if upmask is None else upmask[0], d_cull)


class FactorGraph:
    def __init__(self, video, update_apply, params, max_factors=-1, upsample=False):
        self.video = video
        self.upsample = upsample
        self.update_apply = update_apply  # update_apply(params, net, inp, corr, motn, kk, M, emask)
        self.params = params
        self.max_factors = max_factors
        self.cfg = video.cfg
        self.device = dev = video.device

        self.ii = np.zeros(0, np.int64)
        self.jj = np.zeros(0, np.int64)
        self.age = np.zeros(0, np.int64)

        h8, w8 = video.h8, video.w8
        self.net = torch.zeros(0, h8, w8, 128, dtype=video.nets.dtype, device=dev)
        self.target = torch.zeros(0, h8, w8, 2, device=dev)
        self.weight = torch.zeros(0, h8, w8, 2, device=dev)

        # inactive / bad stores (reference :36-42)
        self.ii_inac = np.zeros(0, np.int64)
        self.jj_inac = np.zeros(0, np.int64)
        self.target_inac = torch.zeros(0, h8, w8, 2, device=dev)
        self.weight_inac = torch.zeros(0, h8, w8, 2, device=dev)
        self.ii_bad = np.zeros(0, np.int64)
        self.jj_bad = np.zeros(0, np.int64)

    def _t(self, x):
        """Host index array -> long tensor on the engine's device."""
        return torch.as_tensor(np.asarray(x, np.int64), device=self.device)

    # ------------------------------------------------------------- edge mgmt

    def add_factors(self, ii, jj, remove=False):
        """Add edges, dropping duplicates (reference :86-134)."""
        ii = np.asarray(ii, np.int64).reshape(-1)
        jj = np.asarray(jj, np.int64).reshape(-1)
        keep = native.dedup_edges(ii, jj, np.concatenate([self.ii, self.ii_inac]),
                                  np.concatenate([self.jj, self.jj_inac]))
        ii, jj = ii[keep], jj[keep]
        if len(ii) == 0:
            return

        # cap the factor count, evicting the oldest (reference :103-107)
        if (self.max_factors > 0 and len(self.ii) + len(ii) > self.max_factors
                and len(self.ii) > 0 and remove):
            ix = np.argsort(self.age)[::-1]
            n_evict = len(self.ii) + len(ii) - self.max_factors
            mask = np.zeros(len(self.ii), bool)
            mask[ix[:n_evict]] = True
            self.rm_factors(mask, store=True)

        net = self.video.nets[self._t(ii)]
        target, _ = self.video.reproject(ii, jj)
        target = target[0]
        self.ii = np.concatenate([self.ii, ii])
        self.jj = np.concatenate([self.jj, jj])
        self.age = np.concatenate([self.age, np.zeros(len(ii), np.int64)])
        self.net = torch.cat([self.net, net], 0)
        self.target = torch.cat([self.target, target], 0)
        self.weight = torch.cat([self.weight, torch.zeros_like(target)], 0)

    def rm_factors(self, mask, store=False):
        """Remove edges; optionally keep them as inactive (reference :137-161)."""
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
        self.net = self.net[kd]
        self.target = self.target[kd]
        self.weight = self.weight[kd]

    def rm_keyframe(self, ix):
        """Drop keyframe ix: shift the buffers, reindex edges (reference :165-194)."""
        self.video.remove_keyframe(ix)

        m = (self.ii_inac == ix) | (self.jj_inac == ix)
        self.ii_inac = np.where(self.ii_inac >= ix, self.ii_inac - 1, self.ii_inac)
        self.jj_inac = np.where(self.jj_inac >= ix, self.jj_inac - 1, self.jj_inac)
        if m.any():
            keep = self._t(np.nonzero(~m)[0])
            self.ii_inac = self.ii_inac[~m]
            self.jj_inac = self.jj_inac[~m]
            self.target_inac = self.target_inac[keep]
            self.weight_inac = self.weight_inac[keep]

        m = (self.ii == ix) | (self.jj == ix)
        self.ii = np.where(self.ii >= ix, self.ii - 1, self.ii)
        self.jj = np.where(self.jj >= ix, self.jj - 1, self.jj)
        self.rm_factors(m, store=False)

    def filter_edges(self):
        """Cull low-confidence long-range edges (reference :71-78)."""
        count_sync("edge_filter")
        conf = self.weight.mean(dim=(1, 2, 3)).cpu().numpy()
        mask = (np.abs(self.ii - self.jj) > 2) & (conf < 0.001)
        self.ii_bad = np.concatenate([self.ii_bad, self.ii[mask]])
        self.jj_bad = np.concatenate([self.jj_bad, self.jj[mask]])
        self.rm_factors(mask, store=False)

    def clear_edges(self):
        self.rm_factors(np.ones(len(self.ii), bool))
        self.net = self.net.new_zeros((0,) + tuple(self.net.shape[1:]))

    # ----------------------------------------------------------------- update

    def _cams(self, ii, jj):
        """The camera of each edge's target features (JAX ``cams``): the
        right one on a stereo self-edge, padding slots (0, 0) included, else
        the left.  Computed on the device from the padded index tensors."""
        return (ii == jj).long() if self.video.stereo else 0

    def _padded_edges(self):
        """Pad edge arrays to the bucketed count with (0, 0) zero-weight edges."""
        n = len(self.ii)
        n_pad = _round_up(max(n, 1), self.cfg.edge_bucket)
        ii = np.zeros(n_pad, np.int64)
        jj = np.zeros(n_pad, np.int64)
        ii[:n] = self.ii
        jj[:n] = self.jj
        return n, n_pad, ii, jj

    def update_fused(self, rounds, t0=None, t1=None, itrs=2, use_inactive=True,
                     cull_pair=None, motion_only=False):
        """``rounds`` x (update operator + dense BA) over the active edges.

        Inactive edges inside the window join the BA with frozen target and
        weight (reference :224-231).  cull_pair: optional (i, j) global frame
        pair whose bidirectional flow distance on the final state is
        returned (the frontend's keyframe-culling test); else None.
        """
        if len(self.ii) == 0 or rounds == 0:
            return None
        video, cfg, dev = self.video, self.cfg, self.device
        with section("update_fused.setup"):
            n, n_pad, ii_p, jj_p = self._padded_edges()
            if t0 is None:
                t0 = max(1, int(self.ii.min()) + 1)
            if t1 is None:
                t1 = int(max(self.ii.max(), self.jj.max())) + 1

            h8, w8 = video.h8, video.w8
            if use_inactive and len(self.ii_inac):
                m = (self.ii_inac >= t0 - 3) & (self.jj_inac >= t0 - 3)
                ii_i, jj_i = self.ii_inac[m], self.jj_inac[m]
                sel = self._t(np.nonzero(m)[0])
                tgt_i, wgt_i = self.target_inac[sel], self.weight_inac[sel]
            else:
                ii_i = jj_i = np.zeros(0, np.int64)
                tgt_i = wgt_i = torch.zeros(0, h8, w8, 2, device=dev)
            ni = len(ii_i)
            ni_pad = _round_up(ni, cfg.edge_bucket) if ni else 0
            zpad = torch.zeros(ni_pad - ni, h8, w8, 2, device=dev)
            tgt_i = torch.cat([tgt_i, zpad], 0)
            wgt_i = torch.cat([wgt_i, zpad], 0)

            # window covering every referenced frame and the free range [t0, t1)
            lows = [int(self.ii.min()), int(self.jj.min()), t0]
            if ni:
                lows += [int(ii_i.min()), int(jj_i.min())]
            MW = _round_up(t1 - min(lows), cfg.window_bucket)
            m0 = max(0, t1 - MW)
            if m0 == 0:
                MW = _round_up(t1, cfg.window_bucket)

            # local indices; padded slots anchor at local frame 0
            ii_a = ii_p - m0
            jj_a = jj_p - m0
            ii_a[n:] = 0
            jj_a[n:] = 0
            ii_il = np.zeros(ni_pad, np.int64)
            jj_il = np.zeros(ni_pad, np.int64)
            ii_il[:ni] = ii_i - m0
            jj_il[:ni] = jj_i - m0
            ii_all = np.concatenate([ii_il, ii_a])
            jj_all = np.concatenate([jj_il, jj_a])
            be, bm = native.bucket_tables(ii_all, MW)

            free = np.zeros(MW, bool)
            free[t0 - m0: t1 - m0] = True
            has_edge = np.zeros(MW, bool)
            has_edge[self.ii - m0] = True
            active = torch.as_tensor(np.arange(n_pad) < n, device=dev).float()

            ii_pt, jj_pt = self._t(ii_p), self._t(jj_p)
            ii_at, jj_at = self._t(ii_a), self._t(jj_a)
            cij = None if cull_pair is None else self._t([cull_pair[0] - m0, cull_pair[1] - m0])

        pad = n_pad - n
        win = slice(m0, m0 + MW)
        count("edges", rounds * n)
        count("edge_slots", rounds * n_pad)
        with section("update_fused.device"):
            poses, disps, damping, nets, target_a, weight_a, upmask, d_cull = fused_rounds(
                self.update_apply, self.params, video.poses[win], video.disps[win],
                video.disps_sens[win], video.damping[win], video.intrinsics[0],
                video.fmaps[ii_pt, 0], video.fmaps[jj_pt, self._cams(ii_pt, jj_pt)],
                torch.cat([self.net, self.net.new_zeros(pad, h8, w8, 128)], 0),
                video.inps[ii_pt],
                torch.cat([self.target, torch.zeros(pad, h8, w8, 2, device=dev)], 0),
                ii_at, jj_at, ii_at.clamp(0, MW - 1), active,
                torch.as_tensor(has_edge, device=dev), self._t(ii_all), self._t(jj_all),
                tgt_i, wgt_i, torch.as_tensor(free, device=dev), self._t(be),
                torch.as_tensor(bm, device=dev), cij, rounds=rounds, ba_iters=itrs,
                lm=cfg.frontend_lm, ep=cfg.frontend_ep, damping_eps=cfg.damping_eps,
                min_depth=cfg.min_depth, beta=cfg.beta, motion_only=motion_only,
                alpha=cfg.rgbd_alpha)

        video.poses[win] = poses
        video.disps[win] = disps
        video.damping[win] = damping
        self.net = nets[:n]
        self.target = target_a[:n]
        self.weight = weight_a[:n]
        if self.upsample:
            ux = np.unique(self.ii)
            video.upsample(self._t(ux), upmask[self._t(ux - m0)])
        self.age += rounds
        return None if d_cull is None else float(d_cull)   # the per-keyframe host sync

    def probe_quality(self):
        """One update-operator step over the active edges, with no BA: the
        multisession match-quality signal (reference
        s_droid_frontend.py:116-146).  Returns each edge's summed confidence
        weight [n] (numpy) and changes only the edges' hidden state.  The
        correlation takes the exact route, K2 in the compute dtype then K3,
        as the JAX package's _build_corr_lookup does; GraphAgg's segments
        are the frames of the window that ends at the last referenced frame."""
        if len(self.ii) == 0:
            return np.zeros(0)
        video, dev = self.video, self.device
        h8, w8 = video.h8, video.w8
        n, n_pad, ii_p, jj_p = self._padded_edges()
        t1 = int(max(self.ii.max(), self.jj.max())) + 1
        MW = _round_up(t1 - int(self.ii.min()), self.cfg.window_bucket)
        m0 = max(0, t1 - MW)
        kk = self._t(np.clip(ii_p - m0, 0, MW - 1))
        emask = torch.as_tensor(np.arange(n_pad) < n, device=dev).float()
        ii, jj = self._t(ii_p), self._t(jj_p)

        coords1 = projective_transform(video.poses[None], video.disps[None],
                                       video.intrinsics[None], ii, jj)[0][0]
        target = torch.cat([self.target, torch.zeros(n_pad - n, h8, w8, 2, device=dev)], 0)
        coords0 = coords_grid(h8, w8, device=dev)
        motn = torch.cat([coords1 - coords0, target - coords1], -1).clamp(-64.0, 64.0)
        with section("corr"):
            levels = corr_build(video.fmaps[ii, 0], video.fmaps[jj, self._cams(ii, jj)])
            corr = corr_lookup(levels, coords1.reshape(n_pad, h8 * w8, 2).contiguous())
        net = torch.cat([self.net, self.net.new_zeros(n_pad - n, h8, w8, 128)], 0)
        count("edges", n)
        count("edge_slots", n_pad)
        net, _, weight, _, _ = self.update_apply(
            self.params, net[None], video.inps[ii][None], corr.reshape(1, n_pad, h8, w8, -1),
            motn[None], kk, MW, emask)
        self.net = net[0, :n]
        count_sync("quality")
        return weight[0, :n].float().sum(dim=(1, 2, 3)).cpu().numpy()

    def _chunk_tables(self, s):
        """Host tables of update_lowmem: edges sorted by source frame, one
        chunk per s-frame band, each padded to EB slots (reference :270);
        with a sharded refresh, empty chunks pad the count to a multiple of
        the shards (JAX :1066-1068).  Returns (nC, nC_pad, EB, tables...)."""
        t = self.video.counter
        order = np.argsort(self.ii, kind="stable")
        ii_s = self.ii[order]
        nC = int(ii_s.max()) // s + 1
        ndev = self._resolved_refresh_shards(nC)
        nC_pad = _round_up(nC, ndev)
        counts = np.array([np.count_nonzero((ii_s >= c * s) & (ii_s < (c + 1) * s))
                           for c in range(nC)])
        EB = _round_up(max(int(counts.max()), 1), self.cfg.edge_bucket)

        ii_ck = np.zeros((nC_pad, EB), np.int64)
        jj_ck = np.zeros((nC_pad, EB), np.int64)
        emask_ck = np.zeros((nC_pad, EB), np.float32)
        pos_ck = np.zeros((nC_pad, EB), np.int64)     # chunk slot -> edge index
        kk_ck = np.zeros((nC_pad, EB), np.int64)
        frame_ck = np.full((nC_pad, s), t, np.int64)  # sentinel t: no edges
        ofs = 0
        for c in range(nC):
            n = int(counts[c])
            sel = order[ofs: ofs + n]
            ii_ck[c, :n] = self.ii[sel]
            jj_ck[c, :n] = self.jj[sel]
            emask_ck[c, :n] = 1.0
            pos_ck[c, :n] = sel
            kk_ck[c, :n] = self.ii[sel] - c * s
            has = np.unique(self.ii[sel]) - c * s
            frame_ck[c, has] = c * s + has
            ofs += n
        slots = np.nonzero(emask_ck.reshape(-1) > 0)[0]
        take_back = np.empty(len(self.ii), np.int64)   # edge -> flat chunk slot
        take_back[pos_ck.reshape(-1)[slots]] = slots
        return nC, nC_pad, EB, ii_ck, jj_ck, emask_ck, pos_ck, kk_ck, frame_ck, take_back

    def _resolved_refresh_shards(self, nC):
        """cfg.refresh_shards with -1 = auto (the JAX package's rule): shard
        the backend's chunks over every local card (``torch.cuda.device_count()``;
        the CPU counts as one device) when there are 2 chunks or more."""
        s = self.cfg.refresh_shards
        if s in (0, 1):
            return 1
        n = local_device_count(self.device) if s == -1 else s
        return n if (n > 1 and nC >= 2) else 1

    def _params_on(self, dev):
        """The update operator's weights on `dev` (a copy made once per
        device other than the engine's)."""
        if dev == self.device:
            return self.params
        copies = self.__dict__.setdefault("_param_copies", {})
        if dev not in copies:
            copies[dev] = copy.deepcopy(self.params).to(dev)
        return copies[dev]

    def _refresh_chunk(self, params, state, c, tables, coords0, nets_c, target_c):
        """Chunk c of update_lowmem's refresh, on the device of the frame
        state copy `state` (poses, disps, intr, fmaps, inps), of the chunk
        tables (ii, jj, kk, emask) and of `params`: returns (nets, target,
        weight, eta, upmask) of its EB slots."""
        ii, jj, kk, emask = (x[c] for x in tables)
        EB = ii.shape[0]
        h8, w8 = self.video.h8, self.video.w8
        coords1 = projective_transform(state["poses"][None], state["disps"][None],
                                       state["intr"][None], ii, jj)[0][0]
        motn = torch.cat([coords1 - coords0, target_c - coords1], -1).clamp(-64.0, 64.0)
        with section("corr"):
            levels = corr_build(state["fmaps"][ii, 0], state["fmaps"][jj, self._cams(ii, jj)],
                                torch.float32)
            corr = corr_lookup(levels, coords1.reshape(EB, h8 * w8, 2).contiguous())
            del levels
        nets, delta, weight, eta, upmask = self.update_apply(
            params, nets_c[None], state["inps"][ii][None], corr.reshape(1, EB, h8, w8, -1),
            motn[None], kk, 8, emask)
        return (nets[0], coords1 + delta[0].float(),
                weight[0].float() * emask[:, None, None, None], eta[0].float(),
                None if upmask is None else upmask[0])

    def update_lowmem(self, steps=8, itrs=2):
        """Global BA over all edges, chunked over source frames
        (reference factor_graph.py:253-300).

        Each step refreshes every edge's update-operator state chunk by
        chunk (8 source frames, up to EB edges) against the same poses, then
        runs one dense BA over the whole video.  A chunk's correlation is
        K2 over its edges, with fp32 levels, followed by K3: the JAX
        package's altcorr_pyramid computes the same function from a pooled
        feature pyramid (pooled in the compute dtype there: the two differ
        within its rounding).

        A sharded refresh (``_resolved_refresh_shards`` > 1, JAX
        ``_lowmem_refresh_sharded``) splits the chunk axis, padded with
        empty chunks, into contiguous blocks, one per shard; shard k runs on
        card k mod the card count against its own copy of the frame state
        and of the update operator.  Each frame's damping and upsampled
        disparities come from the one chunk that wrote them (JAX combines
        them by a written mask): chunks write disjoint frames, so they are
        written into one buffer on the engine's device.  Empty padding
        chunks write nothing and are not run.  Each chunk computes
        what it computes unsharded, so on one device the two refreshes are
        equal bit for bit.
        """
        video, cfg, dev = self.video, self.cfg, self.device
        t = video.counter
        s = 8
        if len(self.ii) == 0:
            return
        h8, w8 = video.h8, video.w8
        nC, nC_pad, EB, ii_ck, jj_ck, emask_ck, pos_ck, kk_ck, frame_ck, take_back = \
            self._chunk_tables(s)
        self.chunks = (nC, EB)
        shards = self._resolved_refresh_shards(nC)
        per = nC_pad // shards
        devices = local_devices(dev) if shards > 1 else [dev]
        shard_devices = [devices[k % len(devices)] for k in range(shards)]
        flat_src = self._t(pos_ck[:nC].reshape(-1))
        take_back = self._t(take_back)
        # per chunk with upsampling: its slots that hold a frame, and those frames
        up_slots = ([(self._t(np.nonzero(f < t)[0]), self._t(f[f < t])) for f in frame_ck]
                    if self.upsample else None)
        frame_ck = self._t(frame_ck)
        # the chunk tables and pixel grid on each shard device
        on = {d: (tuple(torch.as_tensor(x, device=d) for x in (ii_ck, jj_ck, kk_ck, emask_ck)),
                  coords_grid(h8, w8, device=d)) for d in dict.fromkeys(shard_devices)}

        for _ in range(steps):
            # every chunk's real edges and its EB slots
            count("edges", len(self.ii))
            count("edge_slots", nC * EB)
            with section("refresh"):
                nets_ck = self.net[flat_src].reshape(nC, EB, h8, w8, -1)
                target_ck = self.target[flat_src].reshape(nC, EB, h8, w8, 2)
                full = {"poses": video.poses[:t], "disps": video.disps[:t],
                        "intr": video.intrinsics[:t], "fmaps": video.fmaps[:t],
                        "inps": video.inps[:t]}
                damping_ext = torch.cat([video.damping[:t],
                                         video.damping.new_zeros(1, h8, w8)], 0)
                outs = []
                for k, sdev in enumerate(shard_devices):
                    tables, coords0 = on[sdev]
                    state = {key: x.to(sdev) for key, x in full.items()}
                    params = self._params_on(sdev)
                    for c in range(k * per, min((k + 1) * per, nC)):
                        nets, target, weight, eta, upmask = self._refresh_chunk(
                            params, state, c, tables, coords0, nets_ck[c].to(sdev),
                            target_ck[c].to(sdev))
                        # chunks write disjoint frames: slots without edges land in row t
                        damping_ext[frame_ck[c]] = eta.to(dev)
                        if self.upsample:   # from the disparities before this step's BA
                            slot, frame = up_slots[c]
                            video.upsample(frame, upmask.to(dev)[slot])
                        outs.append((nets.to(dev), target.to(dev), weight.to(dev)))
                self.net = torch.cat([o[0] for o in outs], 0)[take_back]
                self.target = torch.cat([o[1] for o in outs], 0)[take_back]
                self.weight = torch.cat([o[2] for o in outs], 0)[take_back]
                video.damping[:t] = damping_ext[:t]

            # one dense BA over the whole video (reference :297)
            video.ba(self.target, self.weight, self.ii, self.jj, 1, t,
                     iterations=itrs, lm=cfg.backend_lm, ep=cfg.backend_ep)
            video.dirty[:t] = True

    # ------------------------------------------------------- edge proposals

    def add_neighborhood_factors(self, t0, t1, r=3):
        """Edges between frames within radius r (reference :302-312); a
        stereo graph leaves out the |i-j| = 1 pairs too, as the JAX package
        does."""
        ii, jj = neighbourhood_graph(t1 - t0, r, c=1 if self.video.stereo else 0)
        self.add_factors(ii + t0, jj + t0)

    def add_proximity_factors(self, t0=0, t1=0, rad=2, nms=2, beta=0.25,
                              thresh=16.0, remove=False):
        """Distance-based edge selection with NMS (reference :315-379)."""
        t = self.video.counter
        if t - t0 <= 0 or t - t1 <= 0:
            return
        with section("select"):
            count_sync("select")  # blocking edge-selection sync (the port has no prefetch)
            d = self.video.distance_matrix(t0, t1, t, beta=beta)
            ii, jj = native.proximity_select(
                d, t0, t1, t, rad, nms, thresh, self.max_factors,
                np.concatenate([self.ii, self.ii_bad, self.ii_inac]),
                np.concatenate([self.jj, self.jj_bad, self.jj_inac]), self.video.stereo)
            if len(ii):
                self.add_factors(ii, jj, remove)
