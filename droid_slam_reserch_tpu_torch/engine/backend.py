"""Global BA backend (mirror of engine/backend.py; reference droid_backend.py:9-41)."""
from ..utils.timing import count_sync, section
from .factor_graph import FactorGraph


class Backend:
    def __init__(self, update_apply, params, video, config):
        self.update_apply = update_apply
        self.params = params
        self.video = video
        self.cfg = config
        self.runs = []   # per call: edges, chunks and edges per chunk (EB) of its graph

    def __call__(self, steps=12):
        with section("backend"):
            self._run(steps)

    def _run(self, steps):
        v, cfg = self.video, self.cfg
        t = v.counter
        if t < 2:
            return

        # mono without depth sensing: fix the scale gauge (reference :29-30)
        if not v.stereo:
            count_sync("normalize")
            if not bool((v.disps_sens[:t] > 0).any()):
                v.normalize()

        graph = FactorGraph(v, self.update_apply, self.params, max_factors=16 * t,
                            upsample=cfg.upsample)
        graph.add_proximity_factors(rad=cfg.backend_radius, nms=cfg.backend_nms,
                                    thresh=cfg.backend_thresh, beta=cfg.beta)
        # update_lowmem's default BA iterations, as the JAX backend runs them
        # (it reads no cfg.ba_iters)
        graph.update_lowmem(steps=steps)
        self.runs.append({"edges": len(graph.ii), "chunks": graph.chunks[0],
                          "EB": graph.chunks[1]})
        graph.clear_edges()
        v.dirty[:t] = True
