"""The port's Sim3, the SE3/SO3 functions the training path adds, the Sim3
projective transform and the training graph helpers against the JAX
package (CPU, float32, inputs made with numpy from seeds).

Values agree within 1e-5 (the same closed forms, rounded in another
order); gradients, taken by torch.autograd and jax.grad of the same random
projection of the output, within 1e-4, at random points, near the identity
and at it.  Near the identity means inside the closed forms' series
branches (theta^2 < 1e-8, |sigma| < 1e-5): rotations of about 2e-5 rad,
where float32 rounds qw to 1.  Between those branches and O(1) angles the
closed forms cancel catastrophically in float32, in both packages alike
(e.g. se3_log's (1 - h cos h / sin h) / theta^2 at theta = 1e-4), so no
comparison is made there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu import geom as jgeom
from droid_slam_reserch_tpu import lie as jlie
from droid_slam_reserch_tpu.geom import graph_utils as jgu
from droid_slam_reserch_tpu_torch import geom as tgeom
from droid_slam_reserch_tpu_torch import lie as tlie
from droid_slam_reserch_tpu_torch.geom import graph_utils as tgu

torch.set_num_threads(1)
TOL, GTOL = 1e-5, 1e-4
SCALES = {"random": 0.7, "near-identity": 2e-5, "identity": 0.0}


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=tol)


def _tangent(rng, n, scale, dim):
    """[n, dim] tangents: translations O(1), rotations (and log-scale) O(scale)."""
    xi = scale * rng.standard_normal((n, dim))
    xi[:, :3] = rng.standard_normal((n, 3)) if scale else 0.0
    if dim == 7 and scale < 1e-3:                 # sigma inside its series branch
        xi[:, 6] = np.clip(0.15 * xi[:, 6], -9e-6, 9e-6)
    return xi.astype(np.float32)


def _sim3(rng, n, scale=0.7):
    return np.asarray(jlie.sim3_exp(jnp.asarray(_tangent(rng, n, scale, 7))))


def _grads(fn_t, fn_j, *args, seed=0):
    """Gradients of <w, fn(args)> in both packages, w random."""
    out = np.asarray(fn_j(*map(jnp.asarray, args)))
    w = np.random.RandomState(seed).standard_normal(out.shape).astype(np.float32)
    gj = jax.jit(jax.grad(lambda *a: jnp.sum(fn_j(*a) * w), argnums=tuple(range(len(args)))))(
        *map(jnp.asarray, args))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    (fn_t(*ts) * torch.from_numpy(w)).sum().backward()
    return [t.grad.numpy() for t in ts], [np.asarray(g) for g in gj]


@pytest.mark.parametrize("where", list(SCALES))
def test_sim3_exp_log_values_and_grads(where):
    rng = np.random.RandomState(0)
    xi = _tangent(rng, 32, SCALES[where], 7)
    _close(tlie.sim3_exp(torch.from_numpy(xi)), jlie.sim3_exp(jnp.asarray(xi)))
    gt, gj = _grads(tlie.sim3_exp, jlie.sim3_exp, xi)
    _close(gt[0], gj[0], GTOL)
    X = _sim3(rng, 32, SCALES[where])
    _close(tlie.sim3_log(torch.from_numpy(X)), jlie.sim3_log(jnp.asarray(X)))
    gt, gj = _grads(tlie.sim3_log, jlie.sim3_log, X)
    _close(gt[0], gj[0], GTOL)


@pytest.mark.parametrize("where", list(SCALES))
def test_se3_so3_grads_near_identity(where):
    """se3_exp, se3_log and so3_log are differentiated by the losses."""
    rng = np.random.RandomState(1)
    xi = _tangent(rng, 32, SCALES[where], 6)
    gt, gj = _grads(tlie.se3_exp, jlie.se3_exp, xi)
    _close(gt[0], gj[0], GTOL)
    X = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    for name in ("se3_log", "se3_inv"):
        gt, gj = _grads(getattr(tlie, name), getattr(jlie, name), X)
        _close(gt[0], gj[0], GTOL)
    gt, gj = _grads(tlie.so3_log, jlie.so3_log, X[:, 3:])
    _close(gt[0], gj[0], GTOL)


@pytest.mark.parametrize("fn", ["sim3_mul", "sim3_retr", "sim3_act", "sim3_adjT"])
def test_sim3_binary(fn):
    rng = np.random.RandomState(2)
    X = _sim3(rng, 32)
    Y = {"sim3_mul": lambda: _sim3(rng, 32), "sim3_act": lambda: rng.standard_normal((32, 4)),
         "sim3_retr": lambda: 0.3 * rng.standard_normal((32, 7)),
         "sim3_adjT": lambda: rng.standard_normal((32, 7))}[fn]().astype(np.float32)
    tf, jf = getattr(tlie, fn), getattr(jlie, fn)
    _close(tf(torch.from_numpy(X), torch.from_numpy(Y)), jf(jnp.asarray(X), jnp.asarray(Y)))
    gt, gj = _grads(tf, jf, X, Y)
    for a, b in zip(gt, gj):
        _close(a, b, GTOL)


def test_unary_and_matrices():
    rng = np.random.RandomState(3)
    X = _sim3(rng, 16)
    for fn in ("sim3_inv", "sim3_matrix"):
        _close(getattr(tlie, fn)(torch.from_numpy(X)), getattr(jlie, fn)(jnp.asarray(X)))
    _close(tlie.sim3_identity((2, 3)), jlie.sim3_identity((2, 3)))
    T = np.asarray(jlie.se3_exp(jnp.asarray(_tangent(rng, 64, 1.5, 6))))
    _close(tlie.se3_matrix(torch.from_numpy(T)), jlie.se3_matrix(jnp.asarray(T)))
    M = np.asarray(jlie.se3_matrix(jnp.asarray(T)))
    _close(tlie.se3_from_matrix(torch.from_numpy(M)), jlie.se3_from_matrix(jnp.asarray(M)))
    _close(tlie.matrix_to_quat(torch.from_numpy(M[:, :3, :3])),
           jlie.matrix_to_quat(jnp.asarray(M[:, :3, :3])))
    q = rng.standard_normal((8, 4)).astype(np.float32)
    _close(tlie.quat_normalize(torch.from_numpy(q)), jlie.quat_normalize(jnp.asarray(q)))
    p = rng.standard_normal((64, 3)).astype(np.float32)
    a = rng.standard_normal((64, 6)).astype(np.float32)
    _close(tlie.se3_act3(torch.from_numpy(T), torch.from_numpy(p)),
           jlie.se3_act3(jnp.asarray(T), jnp.asarray(p)))
    _close(tlie.se3_adj(torch.from_numpy(T), torch.from_numpy(a)),
           jlie.se3_adj(jnp.asarray(T), jnp.asarray(a)))


def _scene(seed, P=4, H=6, W=8, group="sim3"):
    rng = np.random.RandomState(seed)
    dim = 7 if group == "sim3" else 6
    xi = 0.05 * rng.standard_normal((1, P, dim))
    exp = jlie.sim3_exp if group == "sim3" else jlie.se3_exp
    poses = np.asarray(exp(jnp.asarray(xi, jnp.float32)))
    disps = (0.5 + rng.rand(1, P, H, W)).astype(np.float32)
    intr = np.broadcast_to(np.array([10.0, 11.0, W / 2, H / 2], np.float32), (1, P, 4)).copy()
    ii, jj = jgeom.neighbourhood_graph(P, 2)
    ii = np.concatenate([ii, [1]]).astype(np.int64)            # one stereo self-edge
    jj = np.concatenate([jj, [1]]).astype(np.int64)
    return poses, disps, intr, ii, jj


@pytest.mark.parametrize("group", ["se3", "sim3"])
def test_projective_transform_groups(group):
    poses, disps, intr, ii, jj = _scene(4, group=group)
    t = [torch.from_numpy(x) for x in (poses, disps, intr, ii, jj)]
    j = [jnp.asarray(x) for x in (poses, disps, intr)] + [ii, jj]
    out_t = tgeom.projective_transform(*t, jacobian=True, group=group)
    out_j = jgeom.projective_transform(*j, jacobian=True, group=group)
    for a, b in zip(out_t[:2] + tuple(out_t[2]), out_j[:2] + tuple(out_j[2])):
        _close(a, b, 1e-4)
    _close(tgeom.projmap(*t, group=group)[0], jgeom.projmap(*j, group=group)[0], 1e-4)
    _close(tgeom.induced_flow(*t, group=group)[0], jgeom.induced_flow(*j, group=group)[0], 1e-4)

    def coords_t(p, d):
        return tgeom.projective_transform(p, d, t[2], t[3], t[4], group=group)[0]

    def coords_j(p, d):
        return jgeom.projective_transform(p, d, j[2], ii, jj, group=group)[0]

    gt, gj = _grads(coords_t, coords_j, poses, disps)
    for a, b in zip(gt, gj):
        _close(a, b, 1e-3)


def test_graph_helpers():
    rng = np.random.RandomState(5)
    d = rng.uniform(0, 40, (7, 7)).astype(np.float32)
    d[2, 5] = np.inf
    for num in (16, 24, 40):
        gt, gj = tgu.build_frame_graph(d, num=num), jgu.build_frame_graph(d, num=num)
        assert list(gt.items()) == list(gj.items())
        for a, b in zip(tgu.graph_to_edge_list(gt), jgu.graph_to_edge_list(gj)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tgu.keyframe_indicies(gt), jgu.keyframe_indicies(gj))
