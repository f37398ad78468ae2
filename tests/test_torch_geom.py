"""The port's projective geometry against the JAX package's (CPU, float32).
Tolerance 1e-5 (relative and absolute): same formulas, same precision."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu import geom as jgeom
from droid_slam_reserch_tpu import lie as jlie
from droid_slam_reserch_tpu.geom.projective import relative_poses as j_relative_poses
from droid_slam_reserch_tpu_torch import geom as tgeom

torch.set_num_threads(1)
TOL = 1e-5
H, W = 6, 10


def _close(a, b):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)


def _scene(seed, P=4):
    rng = np.random.RandomState(seed)
    xi = np.concatenate([0.2 * rng.standard_normal((P, 3)), 0.05 * rng.standard_normal((P, 3))], 1)
    poses = np.array(jlie.se3_exp(jnp.asarray(xi, jnp.float32)))[None]
    disps = (0.5 + rng.rand(1, P, H, W)).astype(np.float32)
    intr = np.broadcast_to(np.array([9.0, 10.0, W / 2, H / 2], np.float32), (1, P, 4)).copy()
    ii, jj = jgeom.neighbourhood_graph(P, 2)
    ii = np.concatenate([ii, [1]]).astype(np.int64)   # one stereo-style self-edge
    jj = np.concatenate([jj, [1]]).astype(np.int64)
    return poses, disps, intr, ii, jj


def test_coords_grid_iproj_proj():
    _close(tgeom.coords_grid(H, W), jgeom.coords_grid(H, W))
    poses, disps, intr, _, _ = _scene(0)
    pt, Jt = tgeom.iproj(torch.from_numpy(disps), torch.from_numpy(intr), jacobian=True)
    pj, Jj = jgeom.iproj(jnp.asarray(disps), jnp.asarray(intr), jacobian=True)
    _close(pt, pj)
    _close(Jt, Jj)
    X = np.array(pj) + np.float32(0.05)
    for rd in (False, True):
        ct, Jct = tgeom.proj(torch.from_numpy(X), torch.from_numpy(intr), jacobian=True,
                             return_depth=rd)
        cj, Jcj = jgeom.proj(jnp.asarray(X), jnp.asarray(intr), jacobian=True, return_depth=rd)
        _close(ct, cj)
        _close(Jct, Jcj)


def test_actp_and_relative_poses():
    poses, disps, intr, ii, jj = _scene(1)
    G_t = tgeom.relative_poses(torch.from_numpy(poses), torch.from_numpy(ii), torch.from_numpy(jj))
    G_j = j_relative_poses(jnp.asarray(poses), jnp.asarray(ii), jnp.asarray(jj))
    _close(G_t, G_j)
    X0 = np.array(jgeom.iproj(jnp.asarray(disps[:, ii]), jnp.asarray(intr[:, ii]))[0])
    Xt, Jat = tgeom.actp(G_t, torch.from_numpy(X0), jacobian=True)
    Xj, Jaj = jgeom.actp(G_j, jnp.asarray(X0), jacobian=True)
    _close(Xt, Xj)
    _close(Jat, Jaj)


@pytest.mark.parametrize("jacobian", [False, True])
def test_projective_transform(jacobian):
    poses, disps, intr, ii, jj = _scene(2)
    args_t = [torch.from_numpy(a) for a in (poses, disps, intr, ii, jj)]
    args_j = [jnp.asarray(a) for a in (poses, disps, intr, ii, jj)]
    out_t = tgeom.projective_transform(*args_t, jacobian=jacobian, min_depth=0.25)
    out_j = jgeom.projective_transform(*args_j, jacobian=jacobian, min_depth=0.25)
    _close(out_t[0], out_j[0])
    _close(out_t[1], out_j[1])
    if jacobian:
        for a, b in zip(out_t[2], out_j[2]):
            _close(a, b)


def test_frame_distance():
    poses, disps, intr, ii, jj = _scene(3, P=5)
    # the last pair sees the frame from behind: the 1000 "invalid" branch
    poses = poses.copy()
    poses[0, 4] = np.array([0, 0, -3.0, 0, 1, 0, 0], np.float32)
    ii = np.array([0, 1, 2, 3, 0, 4], np.int64)
    jj = np.array([1, 0, 3, 1, 4, 0], np.int64)
    dt = tgeom.frame_distance(torch.from_numpy(poses[0]), torch.from_numpy(disps[0]),
                              torch.from_numpy(intr[0, 0]), torch.from_numpy(ii),
                              torch.from_numpy(jj), beta=0.3)
    dj = jgeom.frame_distance(jnp.asarray(poses[0]), jnp.asarray(disps[0]),
                              jnp.asarray(intr[0, 0]), jnp.asarray(ii), jnp.asarray(jj), beta=0.3)
    assert (np.asarray(dj) == 1000.0).any()
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=TOL, atol=TOL)


def test_neighbourhood_graph():
    for n, r in ((5, 2), (8, 3)):
        for a, b in zip(tgeom.neighbourhood_graph(n, r), jgeom.neighbourhood_graph(n, r)):
            np.testing.assert_array_equal(a, b)
