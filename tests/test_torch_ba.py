"""Plain K1 (per-edge BA blocks), ba_iterations and the host graph helpers
of the port against the JAX package (CPU, float32).

Tolerances: the blocks use atol = 2e-4 * max(1, |ref|), as the JAX
package's Pallas BA test does (sums over pixels in another order); poses
and disparities after ba_iterations agree within 1e-4; the host helpers
must give identical integers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu import lie as jlie
from droid_slam_reserch_tpu import native as jnative
from droid_slam_reserch_tpu.ba.solver import ba_iterations as j_ba_iterations
from droid_slam_reserch_tpu.ba.solver import schur_pairs as j_schur_pairs
from droid_slam_reserch_tpu.ba.system import build_system_blocks as j_build_system_blocks
from droid_slam_reserch_tpu.geom import neighbourhood_graph, projective_transform
from droid_slam_reserch_tpu.geom.projective import relative_poses
from droid_slam_reserch_tpu.ops.pallas_ba import build_system_blocks_pallas
from droid_slam_reserch_tpu_torch import native as tnative
from droid_slam_reserch_tpu_torch import ops
from droid_slam_reserch_tpu_torch.ba.solver import _damped_solve, ba_iterations, schur_pairs
from droid_slam_reserch_tpu_torch.ops.cuda_ba import ba_system_blocks

torch.set_num_threads(1)
H, W = 8, 16
KEYS = ("Hii", "Hij", "Hji", "Hjj", "vi", "vj", "Ei", "Ej", "Ck", "wk")


def make_problem(seed, P=4, stereo=False):
    rng = np.random.RandomState(seed)
    xi = np.concatenate([0.1 * rng.standard_normal((P, 3)), 0.03 * rng.standard_normal((P, 3))], 1)
    poses = np.array(jlie.se3_exp(jnp.asarray(xi, jnp.float32)))
    disps = (0.8 + 0.4 * rng.rand(P, H, W)).astype(np.float32)
    intr = np.array([20.0, 22.0, W / 2.0, H / 2.0], np.float32)
    ii, jj = neighbourhood_graph(P, 2)
    if stereo:
        ii = np.concatenate([ii, np.arange(P)])
        jj = np.concatenate([jj, np.arange(P)])
    ii, jj = ii.astype(np.int64), jj.astype(np.int64)
    target = (0.5 + rng.rand(len(ii), H, W, 2) * np.array([W - 1.0, H - 1.0])).astype(np.float32)
    weight = rng.rand(len(ii), H, W, 2).astype(np.float32)
    return poses, disps, intr, ii, jj, target, weight


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
@pytest.mark.parametrize("reference", ["xla", "pallas"])
def test_plain_blocks_match_jax(stereo, reference):
    poses, disps, intr, ii, jj, target, weight = make_problem(0 if not stereo else 1, stereo=stereo)
    P = poses.shape[0]
    ops.reset_counts()
    out = ba_system_blocks(*[torch.from_numpy(a) for a in (target, weight, poses, disps, intr,
                                                          ii, jj)], min_depth=0.25)
    assert ops.counts()["ba_blocks"] == (0, 1)   # CPU tensors: the plain version
    if reference == "xla":
        ref = j_build_system_blocks(
            jnp.asarray(target)[None], jnp.asarray(weight)[None], jnp.asarray(poses)[None],
            jnp.asarray(disps)[None], jnp.broadcast_to(jnp.asarray(intr), (1, P, 4)),
            jnp.asarray(ii), jnp.asarray(jj), min_depth=0.25)
        ref = {k: ref[k][0] for k in KEYS}
    else:
        Gij = relative_poses(jnp.asarray(poses)[None], jnp.asarray(ii), jnp.asarray(jj))[0]
        ref = build_system_blocks_pallas(
            jnp.asarray(target).transpose(0, 3, 1, 2), jnp.asarray(weight).transpose(0, 3, 1, 2),
            jlie.quat_to_matrix(Gij[:, 3:7]), Gij[:, :3], jnp.asarray(disps)[jnp.asarray(ii)],
            jnp.asarray(intr), jnp.asarray(ii != jj), min_depth=0.25, interpret=True)
    for k in KEYS:
        a = np.asarray(ref[k])
        np.testing.assert_allclose(out[k].numpy(), a, atol=2e-4 * max(1.0, np.abs(a).max()),
                                   err_msg=k)


def _ba_problem(seed, MW=6):
    rng = np.random.RandomState(seed)
    xi = np.concatenate([0.1 * np.arange(MW)[:, None] * np.array([[1.0, 0.2, 0.1]]),
                         0.01 * rng.standard_normal((MW, 3))], 1)
    poses = np.array(jlie.se3_exp(jnp.asarray(xi, jnp.float32)))
    disps = (0.8 + 0.4 * rng.rand(MW, H, W)).astype(np.float32)
    intr = np.array([20.0, 22.0, W / 2.0, H / 2.0], np.float32)
    ii, jj = neighbourhood_graph(MW - 1, 2)
    # two zero-weight padding edges (0, 0), as the engine pads
    ii = np.concatenate([ii, [0, 0]]).astype(np.int64)
    jj = np.concatenate([jj, [0, 0]]).astype(np.int64)
    coords, _ = projective_transform(jnp.asarray(poses)[None], jnp.asarray(disps)[None],
                                     jnp.broadcast_to(jnp.asarray(intr), (1, MW, 4)),
                                     jnp.asarray(ii), jnp.asarray(jj))
    target = (np.asarray(coords[0]) + rng.standard_normal(coords.shape[1:])).astype(np.float32)
    weight = rng.rand(len(ii), H, W, 2).astype(np.float32)
    weight[-2:] = 0.0
    eta = (1e-3 + 1e-2 * rng.rand(MW, H, W)).astype(np.float32)
    free = np.arange(MW) >= 1
    free[-1] = False                     # one frame past the edges stays fixed
    be, bm = jnative.bucket_tables(ii, MW)
    return poses, disps, intr, np.zeros_like(disps), target, weight, eta, ii, jj, free, be, bm


@pytest.mark.parametrize("motion_only", [False, True], ids=["full", "motion_only"])
def test_ba_iterations_match_jax(motion_only):
    args = _ba_problem(2)
    ref = j_ba_iterations(*[jnp.asarray(a) for a in args], iterations=2, lm=1e-4, ep=0.1,
                          motion_only=motion_only, min_depth=0.25)
    out = ba_iterations(*[torch.from_numpy(np.asarray(a)) for a in args[:-2]],
                        torch.from_numpy(args[-2].astype(np.int64)), torch.from_numpy(args[-1]),
                        iterations=2, lm=1e-4, ep=0.1, motion_only=motion_only, min_depth=0.25)
    assert not np.allclose(np.asarray(ref[0]), args[0], atol=1e-4)   # the solve moved poses
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_damped_solve_failure_gives_zero_step():
    S = -torch.eye(12)
    v = torch.ones(12)
    assert torch.equal(_damped_solve(S, v, 1e-4, 0.1), torch.zeros(12))
    A = torch.eye(12) * 2.0
    np.testing.assert_allclose(_damped_solve(A, v, 0.0, 0.0).numpy(), 0.5 * np.ones(12), rtol=1e-6)


def test_bucket_tables_match_jax():
    rng = np.random.RandomState(3)
    ii = rng.randint(0, 16, 100).astype(np.int32)
    for R in (None, 12):
        for a, b in zip(schur_pairs(ii, 16, R), j_schur_pairs(ii, 16, R)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tnative.bucket_tables(ii, 16), jnative.bucket_tables(ii, 16)):
        np.testing.assert_array_equal(a, b)


def test_dedup_matches_jax():
    rng = np.random.RandomState(4)
    ii, jj, ex_i, ex_j = (rng.randint(0, 10, n).astype(np.int64) for n in (50, 50, 30, 30))
    np.testing.assert_array_equal(tnative.dedup_edges(ii, jj, ex_i, ex_j),
                                  jnative.dedup_edges(ii, jj, ex_i, ex_j))


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_proximity_select_matches_jax_native(seed):
    rng = np.random.RandomState(seed)
    t0, t1, t = 3, 1, 14
    d = (40.0 * rng.rand(t - t0, t - t1)).astype(np.float64)
    ex_i = rng.randint(0, t, 10).astype(np.int32)
    ex_j = rng.randint(0, t, 10).astype(np.int32)
    for stereo in (False, True):
        a = tnative.proximity_select(d.copy(), t0, t1, t, 2, 1, 16.0, 24, ex_i, ex_j, stereo)
        b = jnative.proximity_select(d.copy(), t0, t1, t, 2, 1, 16.0, 24, ex_i, ex_j, stereo)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
