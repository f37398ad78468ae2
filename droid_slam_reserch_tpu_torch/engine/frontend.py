"""Local tracking frontend (mirror of engine/frontend.py): ``Frontend`` and
the multisession ``SessionFrontend`` with its quality gate."""
import numpy as np
import torch

from ..utils.timing import count_sync, section
from .factor_graph import FactorGraph


class Frontend:
    def __init__(self, update_apply, params, video, config):
        self.video = video
        self.cfg = config
        self.graph = FactorGraph(video, update_apply, params, max_factors=config.max_factors,
                                 upsample=config.upsample)
        self.t0 = 0
        self.t1 = 0
        self.is_initialized = False
        self.count = 0

    def _run_updates(self, rounds, t0=None, cull_pair=None):
        return self.graph.update_fused(rounds, t0=t0, use_inactive=True, cull_pair=cull_pair)

    def _add_keyframe(self):
        """Take the new keyframe in: retire old edges, add proximity edges
        (reference :37-48), and seed its disparity from the sensor where it
        has one (RGB-D, reference :49-50)."""
        cfg, v, g = self.cfg, self.video, self.graph
        self.count += 1
        self.t1 += 1

        if len(g.ii) > 0:
            g.rm_factors(g.age > cfg.max_age, store=True)
        g.add_proximity_factors(
            self.t1 - 5, max(self.t1 - cfg.frontend_window, 0), rad=cfg.frontend_radius,
            nms=cfg.frontend_nms, thresh=cfg.frontend_thresh, beta=cfg.beta, remove=True)
        dsens = v.disps_sens[self.t1 - 1]
        v.disps[self.t1 - 1] = torch.where(dsens > 0, dsens, v.disps[self.t1 - 1])

    def _seed_next(self):
        """Initialise the next frame's pose and disparity by copy (reference
        :71-72) and mark the keyframes the update moved."""
        v, g = self.video, self.graph
        v.poses[self.t1] = v.poses[self.t1 - 1]
        v.disps[self.t1] = v.disps[self.t1 - 1].mean()
        # the edge list lives on the host
        if len(g.ii) > 0:
            v.dirty[int(g.ii.min()):self.t1] = True

    def _update(self):
        """Add edges for the new keyframe, update, cull (reference :37-75)."""
        cfg, v, g = self.cfg, self.video, self.graph
        self._add_keyframe()

        # keyframe culling by flow distance on the state after the update
        d_cull = self._run_updates(cfg.iters1, cull_pair=(self.t1 - 3, self.t1 - 2))
        if d_cull is None:  # empty graph: no update ran
            d_cull = v.distance([self.t1 - 3], [self.t1 - 2], beta=cfg.beta)[0]
        count_sync("cull")  # the culling decision reads the update's distance on the host
        if d_cull < cfg.keyframe_thresh:
            g.rm_keyframe(self.t1 - 2)
            v.counter -= 1
            self.t1 -= 1
        else:
            self._run_updates(cfg.iters2)
        self._seed_next()

    def _initialize(self):
        """Bootstrap the map (reference :77-110)."""
        cfg, v, g = self.cfg, self.video, self.graph
        self.t0 = 0
        self.t1 = v.counter

        g.add_neighborhood_factors(self.t0, self.t1, r=3)
        self._run_updates(cfg.init_iters, t0=1)
        g.add_proximity_factors(0, 0, rad=2, nms=2, thresh=cfg.frontend_thresh, remove=False)
        self._run_updates(cfg.init_iters, t0=1)

        v.poses[self.t1] = v.poses[self.t1 - 1]
        v.disps[self.t1] = v.disps[self.t1 - 4: self.t1].mean()
        self.is_initialized = True
        v.dirty[:self.t1] = True
        g.rm_factors(g.ii < cfg.warmup - 4, store=True)

    def __call__(self):
        with section("frontend"):
            self._step()

    def _step(self):
        if not self.is_initialized and self.video.counter == self.cfg.warmup:
            self._initialize()
        elif self.is_initialized and self.t1 < self.video.counter:
            self._update()


class SessionFrontend(Frontend):
    """Multisession frontend with confidence-gated keyframe acceptance
    (reference s_droid_frontend.py:9-225).

    With ``config.good`` it is the Frontend.  Without, each keyframe after
    initialisation is verified: one update-operator step (probe_quality)
    and the summed confidence weights of the edges that join the newest
    frame to one of the 2 frames before it must average above
    ``quality_mean_thresh`` with every one above ``quality_min_thresh``;
    else the keyframe is rejected and its timestamp recorded in ``badT``
    (the fork's loop-closure verification signal).
    """

    def __init__(self, update_apply, params, video, config):
        super().__init__(update_apply, params, video, config)
        self.good = config.good
        self.badT = []

    def _update(self):
        if self.good:
            super()._update()
            return
        cfg, v, g = self.cfg, self.video, self.graph
        self._add_keyframe()

        # the quality gate (reference s_droid_frontend.py:116-164)
        summed = g.probe_quality()
        newest = v.counter - 1
        sel = [k for k, (i, j) in enumerate(zip(g.ii, g.jj))
               if (i == newest and newest - 3 < j != i) or (j == newest and newest - 3 < i != j)]
        vals = summed[sel]
        if (len(vals) > 0 and vals.mean() > cfg.quality_mean_thresh
                and np.all(vals > cfg.quality_min_thresh)):
            self._run_updates(cfg.iters1 + cfg.iters2)
            self._seed_next()
        else:
            # slot t1 - 2, as the JAX package's SessionFrontend removes it
            g.rm_keyframe(self.t1 - 2)
            self.badT.append(float(v.tstamp[v.counter - 1]))
            v.counter -= 1
            self.t1 -= 1
