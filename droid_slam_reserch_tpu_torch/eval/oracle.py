"""Oracle gates: the real Frontend / FactorGraph / BA machinery, and the
backend's chunked update_lowmem, on a known trajectory, with an oracle
update operator injected at the ``update_apply`` seam (mirror of the JAX
package's tests/test_engine_oracle_gate.py).

The stored per-edge targets are seeded from ground-truth geometry and the
oracle returns ``delta = target - coords1`` with weight 1 and constant
damping, so every round keeps the oracle targets and a fault anywhere in
windowing, bucketing, the Schur scatter, the free mask or the BA solve shows
as trajectory error.  The correlation kernels still run each round; the
oracle ignores their output.
"""
import numpy as np
import torch

from ..geom import projective_transform
from ..lie import se3_exp, se3_identity, se3_inv, se3_mul
from ..utils import DroidConfig
from ..engine.factor_graph import FactorGraph
from ..engine.frontend import Frontend
from ..engine.video import Video

H8, W8 = 12, 16
T = 12


def gt_scene(pause_at=None):
    """Smooth forward+turn trajectory with spatially varying depth (CPU).

    pause_at: optional frame with (near) zero motion.
    Returns poses [T, 7], disps [T, H8, W8], intrinsics [4].
    """
    xi = np.zeros((T, 6), np.float32)
    xi[:, 0] = 0.05
    xi[:, 1] = 0.01 * np.sin(np.arange(T))
    xi[:, 4] = 0.012
    if pause_at is not None:
        xi[pause_at] = 1e-4
    poses = [se3_identity()]
    for t in range(1, T):
        poses.append(se3_mul(se3_exp(torch.from_numpy(xi[t])), poses[-1]))
    ys, xs = np.meshgrid(np.arange(H8), np.arange(W8), indexing="ij")
    d = 0.8 + 0.2 * np.sin(0.5 * xs) * np.cos(0.4 * ys)
    disps = torch.from_numpy(np.broadcast_to(d, (T, H8, W8)).astype(np.float32).copy())
    intr = torch.tensor([2.0 * W8, 2.0 * W8, W8 / 2.0, H8 / 2.0])
    return torch.stack(poses), disps, intr


def oracle_apply(params, net, inp, corr, motn, kk=None, num_segments=None, emask=None):
    """Oracle update operator: pull every edge to its stored target."""
    delta = motn[..., 2:4]
    weight = torch.ones_like(delta)
    if kk is None:
        return net, delta, weight
    B, N, h, w, _ = net.shape
    eta = torch.full((B, num_segments, h, w), 1e-4, device=net.device)
    return net, delta, weight, eta, None


class OracleGraph(FactorGraph):
    """FactorGraph whose targets are re-seeded from ground truth after every
    edge addition; ``slot2gt`` maps buffer slots to ground-truth frames so
    keyframe removal keeps the oracle exact."""

    def __init__(self, video, gt, **kw):
        super().__init__(video, oracle_apply, None, **kw)
        self._gt = tuple(x.to(video.device) for x in gt)
        self.slot2gt = list(range(int(gt[0].shape[0])))

    def _reseed(self):
        pg, dg, K = self._gt
        sel = self._t(self.slot2gt)
        pg, dg = pg[sel], dg[sel]
        intr = K.expand(pg.shape[0], 4)

        def oracle(ii, jj):
            return projective_transform(pg[None], dg[None], intr[None],
                                        self._t(ii), self._t(jj))[0][0]

        if len(self.ii):
            self.target = oracle(self.ii, self.jj)
        if len(self.ii_inac):
            self.target_inac = oracle(self.ii_inac, self.jj_inac)

    def add_factors(self, ii, jj, remove=False):
        super().add_factors(ii, jj, remove)
        self._reseed()

    def rm_keyframe(self, ix):
        super().rm_keyframe(ix)
        del self.slot2gt[ix]
        self._reseed()


def cam_centers(poses):
    """World-to-camera 7-vectors -> camera centres in the world frame (numpy)."""
    return se3_inv(torch.as_tensor(poses).cpu())[:, :3].numpy()


def drive_frontend(gt, device="cuda", **cfg_kw):
    """Feed the T ground-truth frames through Video + Frontend with the oracle."""
    poses_gt, disps_gt, intr = gt
    base = dict(
        image_size=(H8 * 8, W8 * 8), buffer=T + 8, warmup=5,
        keyframe_thresh=0.0, frontend_thresh=64.0, frontend_window=T,
        frontend_radius=2, frontend_nms=1, max_factors=96,
        init_iters=6, iters1=3, iters2=2, edge_bucket=8, window_bucket=4,
    )
    base.update(cfg_kw)
    cfg = DroidConfig(**base)
    v = Video(cfg, device)
    front = Frontend(oracle_apply, None, v, cfg)
    front.graph = OracleGraph(v, (poses_gt, disps_gt, intr), max_factors=cfg.max_factors)

    zf = torch.zeros(1, H8, W8, 128, device=v.device)
    z = torch.zeros(H8, W8, 128, device=v.device)
    intr = torch.as_tensor(intr, device=v.device)
    with torch.no_grad():
        for t in range(T):
            pose, disp = (se3_identity(device=v.device), 1.0) if t == 0 else (None, None)
            v.append(float(t), None, pose, disp, None, intr, zf, z, z)
            front()
    return v, front


def drive_backend(video, gt, steps=2, itrs=2):
    """The backend gate (tests/test_engine_oracle_gate.py:163-177): a global
    oracle graph over every keyframe of ``video``, refined by update_lowmem."""
    graph = OracleGraph(video, gt, max_factors=16 * T)
    graph.add_proximity_factors(rad=2, nms=2, thresh=64.0, beta=0.3)
    with torch.no_grad():
        graph.update_lowmem(steps=steps, itrs=itrs)
    return graph
