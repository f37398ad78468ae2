"""Local tracking frontend (mirror of engine/frontend.py, ``Frontend`` only)."""
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

    def _update(self):
        """Add edges for the new keyframe, update, cull (reference :37-75)."""
        cfg, v, g = self.cfg, self.video, self.graph
        self.count += 1
        self.t1 += 1

        if len(g.ii) > 0:
            g.rm_factors(g.age > cfg.max_age, store=True)
        g.add_proximity_factors(
            self.t1 - 5, max(self.t1 - cfg.frontend_window, 0), rad=cfg.frontend_radius,
            nms=cfg.frontend_nms, thresh=cfg.frontend_thresh, beta=cfg.beta, remove=True)

        # RGB-D: seed the new keyframe's disparity from the sensor (reference :49-50)
        dsens = v.disps_sens[self.t1 - 1]
        v.disps[self.t1 - 1] = torch.where(dsens > 0, dsens, v.disps[self.t1 - 1])

        # keyframe culling by flow distance on the state after the update
        d_cull = self._run_updates(cfg.iters1, cull_pair=(self.t1 - 3, self.t1 - 2))
        if d_cull is None:  # empty graph: no update ran
            d_cull = v.distance([self.t1 - 3], [self.t1 - 2], beta=cfg.beta)[0]
        count_sync()  # the culling decision reads the update's distance on the host
        if d_cull < cfg.keyframe_thresh:
            g.rm_keyframe(self.t1 - 2)
            v.counter -= 1
            self.t1 -= 1
        else:
            self._run_updates(cfg.iters2)

        # initialise the next frame's pose and disparity by copy (reference :71-72)
        v.poses[self.t1] = v.poses[self.t1 - 1]
        v.disps[self.t1] = v.disps[self.t1 - 1].mean()
        # the keyframes this update moved; the edge list lives on the host
        if len(g.ii) > 0:
            v.dirty[int(g.ii.min()):self.t1] = True

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
