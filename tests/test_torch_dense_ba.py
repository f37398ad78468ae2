"""The port's training BA against the JAX package (CPU, float32, inputs
made with numpy from seeds): the failure-tolerant Cholesky solve and its
backward, the batched per-edge blocks, and one BA and one MoBA step in SE3
and Sim3, differentiated with respect to every input.

Tolerances: the Cholesky solve within 1e-5 (its gradients 1e-4), the
blocks within 1e-4 relative to their largest entry, the BA outputs within
1e-4, and every BA gradient within 1e-3 relative L2 (a Schur solve amplifies
the rounding of the blocks)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu import lie as jlie
from droid_slam_reserch_tpu.ba import chol as jchol
from droid_slam_reserch_tpu.ba import dense as jdense
from droid_slam_reserch_tpu.ba import system as jsystem
from droid_slam_reserch_tpu.geom import neighbourhood_graph
from droid_slam_reserch_tpu_torch.ba import chol as tchol
from droid_slam_reserch_tpu_torch.ba import dense as tdense
from droid_slam_reserch_tpu_torch.ba import system as tsystem

torch.set_num_threads(1)
P, H, W = 4, 6, 8


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=tol)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("pd", [True, False], ids=["pd", "not-pd"])
def test_cholesky_solve_safe(pd):
    """Forward and backward against the JAX custom VJP; batch item 1 of
    the non-PD case cannot be factored and gets a zero solution and zero
    gradients, item 0 is solved as usual."""
    rng = np.random.RandomState(0)
    A = rng.standard_normal((2, 6, 6))
    H_ = (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(6)).astype(np.float32)
    if not pd:
        H_[1] -= 20.0 * np.eye(6, dtype=np.float32)
    b = rng.standard_normal((2, 6, 2)).astype(np.float32)
    w = rng.standard_normal((2, 6, 2)).astype(np.float32)

    xj, vjp = jax.vjp(jchol.cholesky_solve_safe, jnp.asarray(H_), jnp.asarray(b))
    dHj, dbj = vjp(jnp.asarray(w))
    Ht, bt = torch.tensor(H_, requires_grad=True), torch.tensor(b, requires_grad=True)
    xt = tchol.cholesky_solve_safe(Ht, bt)
    xt.backward(torch.from_numpy(w))
    _close(xt.detach(), xj, 1e-5)
    _close(Ht.grad, dHj, 1e-4)
    _close(bt.grad, dbj, 1e-4)
    if not pd:
        assert not xt[1].any() and not Ht.grad[1].any() and not bt.grad[1].any()
        assert xt[0].abs().sum() > 0


def _problem(seed, group, B=2):
    rng = np.random.RandomState(seed)
    dim = 7 if group == "sim3" else 6
    exp = jlie.sim3_exp if group == "sim3" else jlie.se3_exp
    xi = 0.05 * rng.standard_normal((B, P, dim))
    xi[..., :3] *= 2.0
    poses = np.array(exp(jnp.asarray(xi, jnp.float32)))
    disps = (0.5 + 0.5 * rng.rand(B, P, H, W)).astype(np.float32)
    intr = np.broadcast_to(np.array([10.0, 11.0, W / 2, H / 2], np.float32), (B, P, 4)).copy()
    ii, jj = neighbourhood_graph(P, 2)
    ii = np.concatenate([ii, [2]]).astype(np.int64)            # a stereo self-edge
    jj = np.concatenate([jj, [2]]).astype(np.int64)
    N = len(ii)
    target = (np.array([W / 2, H / 2]) + rng.standard_normal((B, N, H, W, 2))
              * np.array([W / 3, H / 3])).astype(np.float32)
    weight = rng.rand(B, N, H, W, 2).astype(np.float32)
    eta = (1e-3 + 1e-2 * rng.rand(B, P, H, W)).astype(np.float32)
    return poses, disps, intr, ii, jj, target, weight, eta


@pytest.mark.parametrize("group", ["se3", "sim3"])
def test_system_blocks(group):
    poses, disps, intr, ii, jj, target, weight, _ = _problem(1, group)
    bt = tsystem.build_system_blocks(*(torch.from_numpy(x) for x in (target, weight, poses, disps,
                                                                      intr, ii, jj)), group=group)
    bj = jsystem.build_system_blocks(*(jnp.asarray(x) for x in (target, weight, poses, disps,
                                                                 intr)), ii, jj, group=group)
    assert bt.keys() == bj.keys()
    for k in bt:
        b = np.asarray(bj[k])
        _close(bt[k] / max(np.abs(b).max(), 1.0), b / max(np.abs(b).max(), 1.0), 1e-4)


@pytest.mark.parametrize("step", ["BA", "MoBA"])
@pytest.mark.parametrize("group", ["se3", "sim3"])
def test_ba_step_values_and_grads(step, group):
    """Outputs, and torch.autograd against jax.grad of <w, outputs> with
    respect to target, weight, eta, poses, disps and intrinsics."""
    poses, disps, intr, ii, jj, target, weight, eta = _problem(2, group)
    args = [target, weight, eta, poses, disps, intr]
    fixedp = 1

    def outs_j(*a):
        out = getattr(jdense, step)(*a, ii, jj, fixedp=fixedp, group=group)
        return out if step == "BA" else (out,)

    oj = jax.jit(outs_j)(*map(jnp.asarray, args))
    ws = [np.random.RandomState(9 + i).standard_normal(o.shape).astype(np.float32)
          for i, o in enumerate(oj)]
    gj = jax.jit(jax.grad(lambda *a: sum(jnp.sum(o * w) for o, w in zip(outs_j(*a), ws)),
                  argnums=tuple(range(len(args)))))(*map(jnp.asarray, args))

    ts = [torch.tensor(a, requires_grad=True) for a in args]
    ot = getattr(tdense, step)(*ts, torch.from_numpy(ii), torch.from_numpy(jj), fixedp=fixedp,
                               group=group)
    ot = ot if step == "BA" else (ot,)
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(ot, ws)).backward()
    for a, b in zip(ot, oj):
        _close(a.detach(), b, 1e-4)
    assert np.abs(np.asarray(oj[0]) - poses).max() > 1e-4        # the step moved the poses
    for name, t, g in zip(("target", "weight", "eta", "poses", "disps", "intrinsics"), ts, gj):
        if step == "MoBA" and name == "eta":
            assert t.grad is None or not t.grad.any()
            continue
        assert _rel(t.grad, g) < 1e-3, (name, _rel(t.grad, g))
