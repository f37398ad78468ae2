"""The port's parallel/ package and its engine wiring against the JAX
package's, on the CPU (the JAX side on the 8-device virtual mesh of
tests/conftest.py; the port places every shard on ``cpu``).

- partition_edges: every output equal to the JAX function's, a hot
  keyframe included;
- dist_ba_solve at 4 shards, in both exchanges: within 1e-4 of the JAX
  function on 4 of the 8 virtual devices (as tests/test_torch_ba.py holds
  ba_iterations), and of the port's single-device ba_iterations; K1 (its
  plain version here) runs once per shard and iteration;
- Video.ba with ba_shards=4 against ba_shards=0: within the JAX package's
  2e-4 on poses and 2e-3 on disparities (tests/test_parallel.py);
- the auto and explicit shard rules (_resolved_ba_shards,
  _resolved_refresh_shards): the JAX package's decisions over a table of
  (window, motion_only, shards, device count);
- update_lowmem with refresh_shards=2 (and 3, one shard of padding only),
  with and without upsampling: equal bit for bit to the unsharded refresh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu import lie as jlie
from droid_slam_reserch_tpu.engine import factor_graph as jfg
from droid_slam_reserch_tpu.engine import video as jvideo
from droid_slam_reserch_tpu.geom import neighbourhood_graph, projective_transform
from droid_slam_reserch_tpu.parallel import dist_ba_solve as j_dist_ba_solve
from droid_slam_reserch_tpu.parallel import make_mesh as j_make_mesh
from droid_slam_reserch_tpu.parallel import partition_edges as j_partition_edges
from droid_slam_reserch_tpu.utils import DroidConfig as JConfig
from droid_slam_reserch_tpu_torch import ops
from droid_slam_reserch_tpu_torch.ba.solver import ba_iterations, schur_pairs
from droid_slam_reserch_tpu_torch.engine import Video
from droid_slam_reserch_tpu_torch.engine import factor_graph as tfg
from droid_slam_reserch_tpu_torch.engine import video as tvideo
from droid_slam_reserch_tpu_torch.engine.net_ops import update_apply
from droid_slam_reserch_tpu_torch.models import DroidNet, init_params
from droid_slam_reserch_tpu_torch.parallel import (dist_ba_solve, init_distributed, make_mesh,
                                                   partition_edges, resolve_exchange)
from droid_slam_reserch_tpu_torch.utils import DroidConfig

torch.set_num_threads(2)
H, W = 6, 8


def make_problem(seed=0, P=8):
    """tests/test_parallel.py's problem, from numpy draws: P poses, a radius-2
    temporal graph with exact targets, the poses and disparities moved off."""
    rng = np.random.RandomState(seed)
    xi = np.concatenate([0.1 * rng.standard_normal((P, 3)), 0.03 * rng.standard_normal((P, 3))],
                        1).astype(np.float32)
    poses_gt = jlie.se3_exp(jnp.asarray(xi))
    disps = (0.8 + 0.4 * rng.rand(P, H, W)).astype(np.float32)
    intr = np.array([30.0, 30.0, W / 2.0, H / 2.0], np.float32)
    ii, jj = neighbourhood_graph(P, 2)
    target, valid = projective_transform(poses_gt[None], jnp.asarray(disps)[None],
                                         jnp.broadcast_to(jnp.asarray(intr), (1, P, 4)), ii, jj)
    target = np.array(target[0])
    weight = np.ones_like(target) * np.array(valid[0])
    dxi = (0.02 * rng.standard_normal((P, 6))).astype(np.float32)
    dxi[0] = 0.0
    poses0 = np.array(jlie.se3_retr(poses_gt, jnp.asarray(dxi)))
    return (poses0, disps * 1.05, intr, np.asarray(ii, np.int64), np.asarray(jj, np.int64),
            target, weight)


PARTITIONS = {
    "temporal": (lambda: (*neighbourhood_graph(8, 2),), 8, 4),
    "hot_keyframe": (lambda: (np.concatenate([np.zeros(64, np.int64), np.arange(1, 32).repeat(2)]),
                              np.concatenate([np.arange(64) % 32,
                                              (np.arange(1, 32) - 1).repeat(2)])), 32, 4),
    "random": (lambda: (np.random.RandomState(5).randint(0, 24, 90),
                        np.random.RandomState(6).randint(0, 24, 90)), 24, 3),
}


@pytest.mark.parametrize("case", sorted(PARTITIONS))
def test_partition_edges_matches_jax(case):
    make, MW, S = PARTITIONS[case]
    ii, jj = (np.asarray(x, np.int64) for x in make())
    rng = np.random.RandomState(1)
    target = rng.standard_normal((len(ii), H, W, 2)).astype(np.float32)
    weight = rng.rand(len(ii), H, W, 2).astype(np.float32)
    got = partition_edges(ii, jj, torch.from_numpy(target), torch.from_numpy(weight), MW, S)
    ref = j_partition_edges(ii, jj, target, weight, MW, S)
    for k, (a, b) in enumerate(zip(got, ref)):
        a = a.numpy() if torch.is_tensor(a) else a     # the edge arrays come back as tensors
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("exchange", ["gather_root", "dense_psum"])
def test_dist_ba_solve_matches_jax(exchange):
    poses0, disps0, intr, ii, jj, target, weight = make_problem()
    P = len(poses0)
    eta = np.full((P, H, W), 1e-4, np.float32)
    free = np.arange(P) >= 1
    dsens = np.zeros_like(disps0)
    parts = partition_edges(ii, jj, torch.from_numpy(target), torch.from_numpy(weight), P, 4)
    jparts = [jnp.asarray(x.numpy() if torch.is_tensor(x) else x) for x in parts]
    jmesh = j_make_mesh((4,), ("kf",), devices=jax.devices()[:4])
    ref = j_dist_ba_solve(jmesh, jnp.asarray(poses0), jnp.asarray(disps0), jnp.asarray(intr),
                          jnp.asarray(dsens), jparts[2], jparts[3], jnp.asarray(eta), jparts[0],
                          jparts[1], jnp.asarray(free), jparts[4], jparts[5], jparts[6], jparts[7],
                          iterations=2, min_depth=0.2, exchange=exchange)

    mesh = make_mesh((4,), ("kf",), devices=["cpu"])
    assert mesh.devices == (torch.device("cpu"),) * 4
    tp = [torch.from_numpy(np.array(x)) for x in (poses0, disps0, intr, dsens, eta, free)]
    ops.reset_counts()
    got = dist_ba_solve(mesh, tp[0], tp[1], tp[2], tp[3], *parts[2:4], tp[4], *parts[0:2], tp[5],
                        *parts[4:], iterations=2, min_depth=0.2, exchange=exchange)
    assert ops.counts()["ba_blocks"] == (0, 4 * 2)     # K1 once per shard and iteration
    assert not np.allclose(got[0].numpy(), poses0, atol=1e-4)   # the solve moved the poses
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)

    be, bm = schur_pairs(ii, P)
    single = ba_iterations(tp[0], tp[1], tp[2], tp[3], torch.from_numpy(target),
                           torch.from_numpy(weight), tp[4], torch.from_numpy(ii),
                           torch.from_numpy(jj), tp[5], torch.from_numpy(be).long(),
                           torch.from_numpy(bm), iterations=2, min_depth=0.2)
    for a, b in zip(got, single):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)


def test_resolve_exchange_and_mesh_placement(monkeypatch):
    assert resolve_exchange("auto", device="cpu") == "gather_root"
    assert resolve_exchange("dense_psum") == "dense_psum"
    with pytest.raises(ValueError):
        resolve_exchange("ring")
    mesh = make_mesh((3,), ("kf",), devices=["cpu", "meta"])
    assert [d.type for d in mesh.devices] == ["cpu", "meta", "cpu"] and mesh.size == 3
    for k in ("DROID_COORDINATOR", "DROID_NUM_PROCESSES", "DROID_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed(backend="gloo") == (0, 1)    # nothing asks for a group


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"), ("cuda", "nccl")])
def test_cli_train_backend_follows_device(monkeypatch, device, backend):
    """cli train joins its group over the backend of --device, whether or
    not a card is visible."""
    import torch.distributed as dist

    from droid_slam_reserch_tpu_torch.cli import main

    class Joined(Exception):
        pass

    def join(backend, **kw):
        raise Joined(backend, kw)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)
    monkeypatch.setattr(dist, "init_process_group", join)
    monkeypatch.setenv("DROID_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("DROID_NUM_PROCESSES", "2")
    monkeypatch.setenv("DROID_PROCESS_ID", "1")
    with pytest.raises(Joined) as e:
        main(["train", "--datapath", "x", "--device", device])
    assert e.value.args == (backend, {"init_method": "tcp://127.0.0.1:1", "world_size": 2,
                                      "rank": 1})


def test_video_ba_sharded_matches_unsharded():
    """Video.ba routes a window through dist_ba_solve when cfg.ba_shards > 1."""
    poses0, disps0, intr, ii, jj, target, weight = make_problem(seed=2)
    T = len(poses0)

    def run(shards):
        cfg = DroidConfig(image_size=(H * 8, W * 8), buffer=T, window_bucket=4,
                          ba_shards=shards)
        v = Video(cfg, device="cpu")
        v.counter = T
        v.poses[:] = torch.from_numpy(poses0)
        v.disps[:] = torch.from_numpy(disps0)
        v.intrinsics[:] = torch.from_numpy(intr)
        v.damping[:] = 5e-4
        ops.reset_counts()
        v.ba(torch.from_numpy(target), torch.from_numpy(weight), ii, jj, 1, T, iterations=2)
        return v.poses[:T].numpy(), v.disps[:T].numpy(), ops.counts()["ba_blocks"]

    p1, d1, c1 = run(0)
    p4, d4, c4 = run(4)
    assert c1 == (0, 2) and c4 == (0, 8)
    assert not np.allclose(p1, poses0, atol=1e-4)
    np.testing.assert_allclose(p4, p1, atol=2e-4)
    np.testing.assert_allclose(d4, d1, atol=2e-3)


# (MW, motion_only, cfg shards, local devices)
BA_RULES = [(mw, mo, s, n) for mw in (16, 64, 127, 128, 512) for mo in (False, True)
            for s in (-1, 0, 1, 2, 4, 24) for n in (1, 2, 8)]
REFRESH_RULES = [(nc, s, n) for nc in (1, 2, 3, 9) for s in (-1, 0, 1, 2, 3) for n in (1, 2, 8)]


def test_shard_rules_match_jax(monkeypatch):
    class Host:       # what the rules read of a Video / FactorGraph
        def __init__(self, cfg, device=None):
            self.cfg, self.device = cfg, device

    for mw, mo, s, n in BA_RULES:
        monkeypatch.setattr(jax, "local_device_count", lambda n=n: n)
        monkeypatch.setattr(tvideo, "local_device_count", lambda device, n=n: n)
        want = jvideo.Video._resolved_ba_shards(Host(JConfig(ba_shards=s)), mw, mo)
        got = tvideo.Video._resolved_ba_shards(Host(DroidConfig(ba_shards=s), "cpu"), mw, mo)
        assert got == want, (mw, mo, s, n)
    for nc, s, n in REFRESH_RULES:
        monkeypatch.setattr(jax, "local_device_count", lambda n=n: n)
        monkeypatch.setattr(tfg, "local_device_count", lambda device, n=n: n)
        want = jfg.FactorGraph._resolved_refresh_shards(Host(JConfig(refresh_shards=s)), nc)
        got = tfg.FactorGraph._resolved_refresh_shards(
            Host(DroidConfig(refresh_shards=s), "cpu"), nc)
        assert got == want, (nc, s, n)
    monkeypatch.undo()
    # with no card, auto never shards
    assert tvideo.Video._resolved_ba_shards(Host(DroidConfig(), "cpu"), 512, False) == 0
    assert tfg.FactorGraph._resolved_refresh_shards(Host(DroidConfig(), "cpu"), 9) == 1


@pytest.fixture(scope="module")
def update_module():
    net = DroidNet()
    net.load_state_dict(init_params(seed=0))
    return net.update.eval().requires_grad_(False)


def _graph_state(shards, upsample, update_module, T=12):
    """A Video of T random keyframes at 64x96 and a radius-2 graph over them
    (2 chunks of 8 source frames), refresh_shards=shards."""
    rng = np.random.RandomState(0)
    cfg = DroidConfig(image_size=(64, 96), buffer=T + 4, refresh_shards=shards, ba_shards=0,
                      upsample=upsample, edge_bucket=8)
    v = Video(cfg, device="cpu")
    v.counter = T
    xi = np.concatenate([0.05 * np.arange(T)[:, None] * np.array([[1.0, 0.1, 0.0]]),
                         0.01 * rng.standard_normal((T, 3))], 1).astype(np.float32)
    from droid_slam_reserch_tpu_torch.lie import se3_exp

    v.poses[:T] = se3_exp(torch.from_numpy(xi))
    v.disps[:T] = torch.from_numpy((0.5 + rng.rand(T, 8, 12)).astype(np.float32))
    v.intrinsics[:T] = torch.tensor([40.0, 40.0, 48.0, 32.0]) / 8.0
    for k in ("fmaps", "nets", "inps"):
        buf = getattr(v, k)
        buf.copy_(torch.from_numpy(rng.standard_normal(tuple(buf.shape)).astype(np.float32)))
    g = tfg.FactorGraph(v, update_apply, update_module, max_factors=16 * T, upsample=upsample)
    ii, jj = neighbourhood_graph(T, 2)
    g.add_factors(ii, jj)
    return v, g


@pytest.mark.parametrize("shards,upsample", [(2, False), (2, True), (3, False)],
                         ids=["shards2", "shards2-upsample", "shards3"])
def test_update_lowmem_sharded_is_bit_equal(shards, upsample, update_module):
    runs = []
    for s in (1, shards):
        v, g = _graph_state(s, upsample, update_module)
        assert g._resolved_refresh_shards(2) == s
        ops.reset_counts()
        with torch.no_grad():
            g.update_lowmem(steps=2)
        assert g.chunks[0] == 2 and ops.counts()["corr_build"] == (0, 4)   # 2 chunks x 2 steps
        runs.append((v, g))
    (v1, g1), (v2, g2) = runs
    for k in ("poses", "disps", "damping"):
        assert torch.equal(getattr(v1, k), getattr(v2, k)), k
    for k in ("net", "target", "weight"):
        assert torch.equal(getattr(g1, k), getattr(g2, k)), k
    if upsample:
        assert v1.disps_up is not None and torch.equal(v1.disps_up, v2.disps_up)
    assert not torch.equal(v1.damping[:12], torch.full_like(v1.damping[:12], 1e-6))


def test_params_copied_once_per_other_device(update_module):
    v, g = _graph_state(2, False, update_module)
    assert g._params_on(torch.device("cpu")) is update_module
    meta = g._params_on(torch.device("meta"))
    assert meta is g._params_on(torch.device("meta")) and meta is not update_module
    assert next(meta.parameters()).device.type == "meta"
    assert next(update_module.parameters()).device.type == "cpu"
