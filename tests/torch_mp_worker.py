"""One rank of the port's 2-rank gloo tests (spawned, not collected, by
tests/test_torch_parallel_mp.py).

    python tests/torch_mp_worker.py step PORT RANK OUT_DIR
    python tests/torch_mp_worker.py cli PORT RANK OUT_DIR DATAPATH

step: joins a 2-rank gloo group and runs, at 64x64, P = 3 frames, one
iteration, a global batch of 2 items:
  - the plain single-process make_train_step on the whole batch (the
    reference; no collective);
  - make_parallel_train_step on a ("dp",) mesh of 2 (one item a rank);
  - make_parallel_train_step on a ("dp", "fsdp") mesh of (1, 2) (every
    parameter and Adam moment split in 2 where an axis divides; the
    parameters gathered back for the comparison);
  - dist_ba_solve over the group (one shard a rank) and in process (both
    shards here), in both exchanges;
and writes what it got to OUT_DIR/step_RANK.npz.
cli: runs ``cli train`` (2 steps, a checkpoint each) with the DROID_*
variables set, from OUT_DIR/rankRANK.
"""
import os
import sys

mode, port, rank, out = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)


def step_mode():
    import torch.distributed as dist

    from droid_slam_reserch_tpu_torch.geom import neighbourhood_graph, projective_transform
    from droid_slam_reserch_tpu_torch.lie import se3_exp, se3_retr
    from droid_slam_reserch_tpu_torch.parallel import (dist_ba_solve, init_distributed,
                                                       make_mesh, make_parallel_train_step,
                                                       partition_edges)
    from droid_slam_reserch_tpu_torch.parallel.train_parallel import MeshAxes
    from droid_slam_reserch_tpu_torch.train import TrainConfig, init_train_state
    from droid_slam_reserch_tpu_torch.train.step import make_train_step

    assert init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo") == (rank, 2)
    res = {}

    # ------------------------------------------------------------ training
    B, P, H, W = 2, 3, 64, 64
    cfg = TrainConfig(batch=1, n_frames=P, iters=1, lr=1e-3, clip=0.1)
    rng = np.random.default_rng(0)
    batch = {
        "images": torch.from_numpy((255.0 * rng.uniform(size=(B, P, H, W, 3))).astype(np.float32)),
        "poses": se3_exp(torch.from_numpy((0.05 * rng.standard_normal((B, P, 6))).astype(
            np.float32))),
        "disps": torch.from_numpy((0.8 + 0.4 * rng.uniform(size=(B, P, H, W))).astype(np.float32)),
        "intrinsics": torch.tensor([40.0, 40.0, W / 2, H / 2]).expand(B, P, 4).contiguous(),
    }
    ii, jj = (torch.from_numpy(np.asarray(x, np.int64)) for x in neighbourhood_graph(P, 2))
    params, opt = init_train_state(cfg, device="cpu")

    ref_p, ref_o, ref_m = make_train_step(cfg, ii, jj)(params, opt, batch)
    res["ref_loss"] = float(ref_m["loss"])
    # the clip binds: the step's gradient norm is above cfg.clip
    from droid_slam_reserch_tpu_torch.train.step import fixed_graph_loss, grads_and_aux, squares

    g, _ = grads_and_aux(fixed_graph_loss(cfg, ii, jj), params, batch)
    res["grad_norm"] = float(torch.sqrt(squares(g)))

    for name, shape, axes in (("dp", (2,), ("dp",)), ("fsdp", (1, 2), ("dp", "fsdp"))):
        mesh = make_mesh(shape, axes, devices=["cpu"], group=dist.group.WORLD)
        step, prepare = make_parallel_train_step(cfg, ii, jj, mesh)
        p, o, b = prepare(params, opt, batch)
        p2, o2, m = step(p, o, b)
        ax = MeshAxes(mesh)
        full = {k: ax.gather(params[k].shape, v) for k, v in p2.items()}
        mu = {k: ax.gather(params[k].shape, v) for k, v in o2["mu"].items()}
        res[f"{name}_loss"] = float(m["loss"])
        res[f"{name}_sliced"] = sum(int(v.numel() < params[k].numel()) for k, v in p2.items())
        for k in params:
            res[f"{name}_p/{k}"] = full[k].numpy()
            res[f"{name}_mu/{k}"] = mu[k].numpy()
    for k in params:
        res[f"ref_p/{k}"] = ref_p[k].numpy()
        res[f"ref_mu/{k}"] = ref_o["mu"][k].numpy()

    # ------------------------------------------------------------ dist BA
    Hs, Ws, T = 6, 8, 8
    r = np.random.RandomState(3)
    xi = np.concatenate([0.1 * r.standard_normal((T, 3)), 0.03 * r.standard_normal((T, 3))], 1)
    poses_gt = se3_exp(torch.from_numpy(xi.astype(np.float32)))
    disps = torch.from_numpy((0.8 + 0.4 * r.rand(T, Hs, Ws)).astype(np.float32))
    intr = torch.tensor([30.0, 30.0, Ws / 2.0, Hs / 2.0])
    ei, ej = (torch.from_numpy(np.asarray(x, np.int64)) for x in neighbourhood_graph(T, 2))
    target, valid = projective_transform(poses_gt[None], disps[None], intr.expand(T, 4)[None],
                                         ei, ej)
    target, weight = target[0], torch.ones_like(target[0]) * valid[0]
    dxi = torch.from_numpy((0.02 * r.standard_normal((T, 6))).astype(np.float32))
    dxi[0] = 0.0
    poses0, disps0 = se3_retr(poses_gt, dxi), disps * 1.05
    eta, free = torch.full((T, Hs, Ws), 1e-4), torch.arange(T) >= 1
    parts = partition_edges(ei.numpy(), ej.numpy(), target, weight, T, 2)
    for exchange in ("gather_root", "dense_psum"):
        for where, mesh in (("group", make_mesh((2,), ("kf",), devices=["cpu"],
                                                group=dist.group.WORLD)),
                            ("local", make_mesh((2,), ("kf",), devices=["cpu"]))):
            p, d = dist_ba_solve(mesh, poses0, disps0, intr, torch.zeros_like(disps0), parts[2],
                                 parts[3], eta, parts[0], parts[1], free, *parts[4:],
                                 iterations=2, min_depth=0.2, exchange=exchange)
            res[f"ba_{where}_{exchange}_poses"] = p.numpy()
            res[f"ba_{where}_{exchange}_disps"] = d.numpy()
    res["ba_moved"] = float((res["ba_local_gather_root_poses"] - poses0.numpy()).__abs__().max())

    np.savez(os.path.join(out, f"step_{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


def cli_mode(datapath):
    from droid_slam_reserch_tpu_torch import cli

    os.environ.update(DROID_COORDINATOR=f"127.0.0.1:{port}", DROID_NUM_PROCESSES="2",
                      DROID_PROCESS_ID=str(rank))
    cwd = os.path.join(out, f"rank{rank}")
    os.makedirs(cwd)
    os.chdir(cwd)
    cli.main(["train", "--datapath", datapath, "--steps", "2", "--n_frames", "4", "--iters", "1",
              "--image_size", "64", "64", "--save_every", "1", "--restart_prob", "0.5",
              "--device", "cpu", "--name", "mp"])
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    print(f"CLI_DONE rank {rank}", flush=True)


if mode == "step":
    step_mode()
else:
    cli_mode(sys.argv[5])
