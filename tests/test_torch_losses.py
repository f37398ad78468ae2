"""The port's training losses and its differentiable correlation pyramid
against the JAX package (CPU, float32, inputs made with numpy from seeds).

Values agree within 1e-5, gradients (torch.autograd against jax.grad)
within 1e-4.  The pose losses are also differentiated at the ground truth
itself, where every relative-pose error is the identity and the safe norm's
guard is what keeps the gradient finite."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu import lie as jlie
from droid_slam_reserch_tpu.geom import losses as jlosses
from droid_slam_reserch_tpu.geom import neighbourhood_graph
from droid_slam_reserch_tpu.ops import corr as jcorr
from droid_slam_reserch_tpu_torch.geom import losses as tlosses
from droid_slam_reserch_tpu_torch.ops import corr as tcorr

torch.set_num_threads(1)
TOL, GTOL = 1e-5, 1e-4
P, H, W = 4, 6, 8


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=tol)


def _poses(rng, n, scale, group):
    dim = 7 if group == "sim3" else 6
    exp = jlie.sim3_exp if group == "sim3" else jlie.se3_exp
    xi = scale * rng.standard_normal((1, n, dim))
    return np.asarray(exp(jnp.asarray(xi, jnp.float32)))


def _check_grads(fn_t, fn_j, args, tol=GTOL, jit=True):
    """fn(*args) -> (scalar loss, metrics): the losses, the metrics and the
    gradients with respect to every argument in args agree.  jit=False runs
    JAX op by op: at the ground truth itself (every error exactly 0) JAX's
    jitted gradient is not its op-by-op gradient, which the port matches."""
    vg = jax.value_and_grad(fn_j, argnums=tuple(range(len(args))), has_aux=True)
    (lj, mj), gj = (jax.jit(vg) if jit else vg)(*map(jnp.asarray, args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    lt, mt = fn_t(*ts)
    lt.backward()
    _close(lt.detach(), lj, TOL)
    assert mt.keys() == mj.keys()
    for k in mt:
        _close(mt[k], mj[k], 1e-4)
    for t, g in zip(ts, gj):
        assert np.isfinite(t.grad.numpy()).all()
        _close(t.grad, g, tol)


@pytest.mark.parametrize("group,do_scale,masked,at", [
    ("se3", False, False, "near"), ("se3", False, True, "near"), ("se3", True, False, "near"),
    ("se3", False, True, "gt"), ("sim3", False, False, "near"), ("sim3", True, True, "near"),
    ("sim3", False, False, "gt")])
def test_geodesic_loss(group, do_scale, masked, at):
    rng = np.random.RandomState(0)
    Ps = _poses(rng, P, 0.3, group)
    mul = jlie.sim3_retr if group == "sim3" else jlie.se3_retr
    dim = Ps.shape[-1] - 1
    Gs = [Ps if at == "gt" else np.asarray(mul(jnp.asarray(Ps), jnp.asarray(
        0.02 * rng.standard_normal((1, P, dim)), jnp.float32))) for _ in range(3)]
    ii, jj = (x.astype(np.int64) for x in neighbourhood_graph(P, 2))
    mask = (rng.rand(len(ii)) > 0.3).astype(np.float32) if masked else None

    def fn_t(*G):
        return tlosses.geodesic_loss(torch.from_numpy(Ps), list(G), ii, jj, do_scale=do_scale,
                                     group=group,
                                     edge_mask=None if mask is None else torch.from_numpy(mask))

    def fn_j(*G):
        return jlosses.geodesic_loss(jnp.asarray(Ps), list(G), ii, jj, do_scale=do_scale,
                                     group=group, edge_mask=None if mask is None else mask)

    _check_grads(fn_t, fn_j, Gs, jit=at != "gt")


@pytest.mark.parametrize("masked", [False, True])
def test_residual_loss(masked):
    rng = np.random.RandomState(1)
    E = 10
    res = [rng.standard_normal((1, E, H, W, 2)).astype(np.float32) for _ in range(3)]
    mask = (rng.rand(E) > 0.4).astype(np.float32) if masked else None
    _check_grads(
        lambda *r: tlosses.residual_loss(list(r), edge_mask=None if mask is None
                                         else torch.from_numpy(mask)),
        lambda *r: jlosses.residual_loss(list(r), edge_mask=mask), res)


@pytest.mark.parametrize("at", ["near", "gt"])
def test_flow_loss(at):
    rng = np.random.RandomState(2)
    Ps = _poses(rng, P, 0.05, "se3")
    disps = (0.5 + rng.rand(1, P, H, W)).astype(np.float32)
    disps[0, 1, :2] = 0.0                                 # invalid ground truth
    intr = np.broadcast_to(np.array([10.0, 11.0, W / 2, H / 2], np.float32), (1, P, 4)).copy()
    noise = 0.0 if at == "gt" else 1.0
    poses_est = [np.asarray(jlie.se3_retr(jnp.asarray(Ps), jnp.asarray(
        noise * 0.01 * rng.standard_normal((1, P, 6)), jnp.float32))) for _ in range(2)]
    disps_est = [(disps + noise * 0.05 * rng.standard_normal(disps.shape)).astype(np.float32)
                 for _ in range(2)]
    args = poses_est + disps_est

    def fn_t(*a):
        return tlosses.flow_loss(torch.from_numpy(Ps), torch.from_numpy(disps), list(a[:2]),
                                 list(a[2:]), torch.from_numpy(intr))

    def fn_j(*a):
        return jlosses.flow_loss(jnp.asarray(Ps), jnp.asarray(disps), list(a[:2]), list(a[2:]),
                                 jnp.asarray(intr))

    _check_grads(fn_t, fn_j, args, jit=at != "gt")


def test_corr_pyramid_values_and_grads():
    """corr_volume -> build_pyramid -> corr_lookup_pyramid, differentiated
    with respect to both feature maps (the coords are detached)."""
    rng = np.random.RandomState(3)
    E, C = 3, 16
    f1 = rng.standard_normal((E, 8, 10, C)).astype(np.float32)
    f2 = rng.standard_normal((E, 8, 10, C)).astype(np.float32)
    coords = (rng.rand(E, 8, 10, 2) * np.array([12.0, 10.0]) - 1.0).astype(np.float32)
    coords[0, 0, 0] = [3.0, 4.0]                          # on the integer grid

    vt = tcorr.corr_volume(torch.from_numpy(f1), torch.from_numpy(f2))
    vj = jcorr.corr_volume(jnp.asarray(f1), jnp.asarray(f2))
    _close(vt, vj)
    for a, b in zip(tcorr.build_pyramid(vt), jcorr.build_pyramid(vj)):
        _close(a, b)
    _close(tcorr.corr_lookup(vt, torch.from_numpy(coords)),
           jcorr.corr_lookup(vj, jnp.asarray(coords)))

    w = rng.standard_normal((E, 8, 10, 4 * 49)).astype(np.float32)

    def fn_t(a, b, c):
        pyr = tcorr.build_pyramid(tcorr.corr_volume(a, b))
        return (tcorr.corr_lookup_pyramid(pyr, c) * torch.from_numpy(w)).sum(), {}

    def fn_j(a, b, c):
        pyr = jcorr.build_pyramid(jcorr.corr_volume(a, b))
        return jnp.sum(jcorr.corr_lookup_pyramid(pyr, c) * w), {}

    (lj, _), gj = jax.jit(jax.value_and_grad(fn_j, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(coords))
    ts = [torch.tensor(x, requires_grad=True) for x in (f1, f2, coords)]
    lt, _ = fn_t(*ts)
    lt.backward()
    _close(lt.detach(), lj, 1e-4)
    _close(ts[0].grad, gj[0], GTOL)
    _close(ts[1].grad, gj[1], GTOL)
    assert ts[2].grad is None and not np.asarray(gj[2]).any()
