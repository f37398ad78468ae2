"""The port's training loss on a fixed graph (fixed_graph_loss, the loss of
make_train_step) against the JAX package's (CPU, float32, 64x64, P = 4
frames, 2 unrolled iterations, the radius-2 temporal graph, JAX weights
mapped by params_from_jax).

The JAX side is make_train_step's loss, written out here from the JAX
package's DroidNet and losses (its step returns parameters, not gradients),
differentiated by jax.grad under one jit.  Tolerances and the two
gradient sets left out of the relative-L2 check are those of
test_torch_train_step.py: the fnet's conv biases in front of an instance
norm (zero in exact arithmetic, held under 1e-6) and the flow encoder's
biases, which the jitted JAX step gets wrong at this initialisation (edges
between frames 1..P-1 have motion exactly 0; see that file)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu import lie as jlie
from droid_slam_reserch_tpu.geom.losses import flow_loss, geodesic_loss, residual_loss
from droid_slam_reserch_tpu.models import DroidNet as JDroidNet
from droid_slam_reserch_tpu.train import TrainConfig
from droid_slam_reserch_tpu.train import init_train_state as j_init
from droid_slam_reserch_tpu_torch.models import params_from_jax
from droid_slam_reserch_tpu_torch.train.step import fixed_graph_loss, grads_and_aux, temporal_graph

from test_torch_train_step import ZERO_GRAD, ZERO_MOTION, _rel

torch.set_num_threads(2)
P, H, W, ITERS = 4, 64, 64, 2
CFG = TrainConfig(batch=1, n_frames=P, iters=ITERS, steps=10)


def make_batch(seed=1):
    rng = np.random.default_rng(seed)
    return dict(
        images=(255.0 * rng.uniform(size=(1, P, H, W, 3))).astype(np.float32),
        poses=np.array(jlie.se3_exp(jnp.asarray(0.05 * rng.standard_normal((1, P, 6)),
                                                jnp.float32))),
        disps=(0.8 + 0.4 * rng.uniform(size=(1, P, H, W))).astype(np.float32),
        intrinsics=np.broadcast_to(np.array([40.0, 40.0, W / 2, H / 2], np.float32),
                                   (1, P, 4)).copy())


def jax_loss(params, batch, ii, jj):
    """make_train_step's loss_fn (JAX train/step.py); ii, jj static tuples."""
    ii, jj = np.asarray(ii, np.int32), np.asarray(jj, np.int32)
    Ps = jlie.se3_inv(batch["poses"])
    Gs = jnp.concatenate([Ps[:, :1], jnp.repeat(Ps[:, 1:2], P - 1, axis=1)], axis=1)
    disp0 = jnp.ones_like(batch["disps"][:, :, 3::8, 3::8])
    poses_est, disps_est, residuals = JDroidNet().apply(
        {"params": params}, Gs, batch["images"], disp0, batch["intrinsics"] / 8.0, ii, jj,
        ITERS, 2)
    geo, geo_m = geodesic_loss(Ps, poses_est, ii, jj, do_scale=False)
    res, res_m = residual_loss(residuals)
    flo, flo_m = flow_loss(Ps, batch["disps"], poses_est, disps_est, batch["intrinsics"])
    loss = CFG.w1 * geo + CFG.w2 * res + CFG.w3 * flo
    return loss, {"loss": loss, "geo": geo, "res": res, "flow": flo, **geo_m, **res_m, **flo_m}


@pytest.fixture(scope="module")
def both():
    ii, jj = temporal_graph(P)
    batch = make_batch()
    jp, _ = j_init(CFG, image_size=(64, 64))
    (_, mj), gj = jax.jit(jax.value_and_grad(jax_loss, has_aux=True), static_argnums=(2, 3))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, tuple(ii), tuple(jj))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ti, tj = torch.from_numpy(ii).long(), torch.from_numpy(jj).long()
    gt, mt = grads_and_aux(fixed_graph_loss(CFG, ti, tj), params, tb)
    return (gt, mt), (params_from_jax(jax.tree_util.tree_map(np.asarray, gj)),
                      {k: float(v) for k, v in mj.items()}), (params, tb, ti, tj)


def test_fixed_graph_loss_and_metrics(both):
    (_, mt), (_, mj), _ = both
    assert mt.keys() == mj.keys()
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), mj[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_fixed_graph_gradients(both):
    (gt, _), (gj, _), _ = both
    bad = {k: _rel(gt[k], gj[k]) for k in gj
           if k not in ZERO_GRAD + ZERO_MOTION and _rel(gt[k], gj[k]) > 1e-3}
    assert not bad, bad
    for k in ZERO_GRAD:
        assert gt[k].norm() < 1e-6 and np.linalg.norm(gj[k]) < 1e-6, k


def test_fixed_graph_remat(both):
    (gt, mt), _, (params, tb, ti, tj) = both
    g1, m1 = grads_and_aux(fixed_graph_loss(CFG, ti, tj, remat=True), params, tb)
    assert float(m1["loss"]) == float(mt["loss"])
    for k in gt:
        torch.testing.assert_close(g1[k], gt[k], rtol=1e-6, atol=1e-9)
