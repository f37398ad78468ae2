"""The port's training step on sampled graphs (make_train_step_dynamic)
against the JAX package's, and the gradient clip at the update operator's
heads (CPU, float32, 64x64, P = 4 frames, 2 unrolled iterations, a graph
from sample_frame_graph padded to 16 edges, JAX weights mapped by
params_from_jax).

Tolerances: loss and metrics within 1e-4 relative, the carry (last poses
and disparities) within 1e-4, every parameter's gradient within 1e-3
relative L2 of JAX's.  Two sets of gradients are not compared by relative
L2:
- the fnet's conv biases in front of an instance norm, whose gradient is
  zero in exact arithmetic: both packages give rounding noise (about 1e-8
  against gradient norms of 1e-2 and more), held under 1e-6 absolute;
- at the ground-truth initialisation (frames 1..P-1 share frame 1's pose,
  so 6 edges have motion features exactly 0) JAX's jitted step returns
  flow-encoder bias gradients 36% away (relative L2) from the same step
  run op by op (``grad_step.__wrapped__``, which the port matches to 1e-6;
  it takes 2 minutes, so it is not run here).  Those two biases are
  compared at the restart initialisation only, where no edge has zero
  motion and the jitted and op-by-op JAX gradients agree within 1e-5.
JAX's step is compiled once (module fixture) and run on three batches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu import lie as jlie
from droid_slam_reserch_tpu.train import TrainConfig
from droid_slam_reserch_tpu.train import init_train_state as j_init
from droid_slam_reserch_tpu.train.step import make_train_step_dynamic as j_dynamic
from droid_slam_reserch_tpu.train.step import sample_frame_graph as j_sample
from droid_slam_reserch_tpu_torch.models import UpdateModule, params_from_jax
from droid_slam_reserch_tpu_torch.train.step import make_train_step_dynamic as t_dynamic

torch.set_num_threads(2)
P, H, W, E_PAD, ITERS = 4, 64, 64, 16, 2
CFG = TrainConfig(batch=1, n_frames=P, iters=ITERS, steps=10)
ZERO_GRAD = [f"fnet.{n}.bias" for n in (
    "conv1", "layer1.0.conv1", "layer1.0.conv2", "layer1.1.conv1", "layer1.1.conv2",
    "layer2.0.conv1", "layer2.0.conv2", "layer2.0.downsample.0", "layer2.1.conv1",
    "layer2.1.conv2", "layer3.0.conv1", "layer3.0.conv2", "layer3.0.downsample.0",
    "layer3.1.conv1", "layer3.1.conv2")]
ZERO_MOTION = ["update.flow_encoder.0.bias", "update.flow_encoder.2.bias"]


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    images = (255.0 * rng.uniform(size=(1, P, H, W, 3))).astype(np.float32)
    poses = np.array(jlie.se3_exp(jnp.asarray(0.05 * rng.standard_normal((1, P, 6)), jnp.float32)))
    disps = (0.8 + 0.4 * rng.uniform(size=(1, P, H, W))).astype(np.float32)
    intr = np.broadcast_to(np.array([40.0, 40.0, W / 2, H / 2], np.float32), (1, P, 4)).copy()
    ii, jj, em = j_sample(np.random.default_rng(seed), poses, disps, intr, P, E_PAD)
    Ps = np.array(jlie.se3_inv(jnp.asarray(poses)))
    Gs0 = np.concatenate([Ps[:, :1], np.repeat(Ps[:, 1:2], P - 1, 1)], 1)
    return dict(images=images, poses=poses, disps=disps, intrinsics=intr, ii=ii, jj=jj,
                emask=em, Gs0=Gs0, disp0=np.ones((1, P, H // 8, W // 8), np.float32))


def restart_batch(batch):
    """Gs0 moved off the ground-truth initialisation, as a restart moves it."""
    xi = 0.01 * np.random.default_rng(7).standard_normal((1, P, 6))
    Gs0 = np.array(jlie.se3_retr(jnp.asarray(batch["Gs0"]), jnp.asarray(xi, jnp.float32)))
    return dict(batch, Gs0=Gs0)


def flipped_batch(batch):
    """The padded edges' jj moved: masked edges must not change the loss."""
    jj = batch["jj"].copy()
    pad = batch["emask"] == 0
    assert pad.any()
    jj[pad] = (jj[pad] + 1) % P
    return dict(batch, jj=jj)


def to_torch(batch):
    out = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    out["ii"], out["jj"] = out["ii"].long(), out["jj"].long()
    return out


@pytest.fixture(scope="module")
def jax_side():
    jp, _ = j_init(CFG, image_size=(64, 64))
    grad_step, _ = j_dynamic(CFG)
    base = make_batch()
    batches = {"gt-init": base, "restart-init": restart_batch(base),
               "flipped": flipped_batch(base)}
    out = {}
    for name, b in batches.items():
        g, m, c = grad_step(jp, {k: jnp.asarray(v) for k, v in b.items()})
        out[name] = (params_from_jax(jax.tree_util.tree_map(np.asarray, g)),
                     {k: float(v) for k, v in m.items()}, [np.asarray(x) for x in c])
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return params, batches, out


@pytest.fixture(scope="module")
def port_grad_step():
    return t_dynamic(CFG)[0]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("init", ["gt-init", "restart-init"])
def test_dynamic_step_matches_jax(jax_side, port_grad_step, init):
    params, batches, out = jax_side
    gj, mj, cj = out[init]
    gt, mt, ct = port_grad_step(params, to_torch(batches[init]))
    assert mt.keys() == mj.keys()
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), mj[k], rtol=1e-4, atol=1e-6, err_msg=k)
    for a, b in zip(ct, cj):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4)
    skip = ZERO_MOTION if init == "gt-init" else []
    bad = {k: _rel(gt[k], gj[k]) for k in gj
           if k not in ZERO_GRAD + skip and _rel(gt[k], gj[k]) > 1e-3}
    assert not bad, bad
    for k in ZERO_GRAD:
        assert gt[k].norm() < 1e-6 and np.linalg.norm(gj[k]) < 1e-6, k


def test_padded_edges_leave_the_loss_alone(jax_side, port_grad_step):
    params, batches, out = jax_side
    _, m0, _ = port_grad_step(params, to_torch(batches["gt-init"]))
    _, m1, _ = port_grad_step(params, to_torch(batches["flipped"]))
    np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(m1["loss"]), out["flipped"][1]["loss"], rtol=1e-4)


def test_remat_gives_the_same_gradients(jax_side, port_grad_step):
    params, batches, _ = jax_side
    b = to_torch(batches["restart-init"])
    g0, m0, _ = port_grad_step(params, b)
    g1, m1, _ = t_dynamic(CFG, remat=True)[0](params, b)
    assert float(m1["loss"]) == float(m0["loss"])
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("head", ["delta", "weight", "eta"])
def test_gradient_clip_at_the_heads(head):
    """A gradient entry above 0.01 in magnitude, or NaN, comes back 0 through
    each head's clip; one of 0.005 comes back as it was."""
    upd = UpdateModule()
    clip = {"delta": upd.delta[3], "weight": upd.weight[3], "eta": upd.agg.eta[1]}[head]
    x = torch.randn(5, requires_grad=True)
    y = clip(x)
    torch.testing.assert_close(y, x)
    y.backward(torch.tensor([0.02, float("nan"), 0.005, -0.02, -0.004]))
    torch.testing.assert_close(x.grad, torch.tensor([0.0, 0.0, 0.005, 0.0, -0.004]))
