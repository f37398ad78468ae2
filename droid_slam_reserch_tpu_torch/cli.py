"""Command-line entry points of the port (mirror of the JAX package's cli.py):
the tracking commands, with the same flags, outputs and printed JSON.

Usage:
  python -m droid_slam_reserch_tpu_torch.cli demo --imagedir DIR --calib FILE
  python -m droid_slam_reserch_tpu_torch.cli euroc --datapath .../MH_01/mav0 --gt gt.txt [--stereo]
  python -m droid_slam_reserch_tpu_torch.cli tum --datapath .../rgbd_dataset_freiburg1_xyz
  python -m droid_slam_reserch_tpu_torch.cli eth3d --datapath DIR [--depth]
  python -m droid_slam_reserch_tpu_torch.cli tartanair --datapath SCENE [--stereo]
  python -m droid_slam_reserch_tpu_torch.cli view --reconstruction A.npz [B.npz ...] --out cloud.ply
  python -m droid_slam_reserch_tpu_torch.cli multisession-align --first A.npz --second B.npz --spec spec.json --out DIR
  python -m droid_slam_reserch_tpu_torch.cli multisession --sessions DIR --out DIR
  python -m droid_slam_reserch_tpu_torch.cli multisession-evaluate --fused fused.npz --spec spec.json
  python -m droid_slam_reserch_tpu_torch.cli train --datapath TARTANAIR_ROOT [--ckpt CKPT.npz]

Every command runs on the CUDA card; ``--device cpu`` runs the plain
PyTorch versions of the kernels on the CPU instead.  ``--vis_path`` streams
the live point cloud into a PLY file while tracking runs.  ``train`` runs
on one device (plain PyTorch under autograd, no kernel of the engine) and
writes checkpoints that ``--weights`` reads.
"""
import argparse
import json
import os

import numpy as np

from .engine import Droid
from .engine.droid import default_params
from .utils.npz import savez_compressed


def _add_slam_flags(p):
    """Shared SLAM flags (reference demo.py:103-128), and the port's --device."""
    p.add_argument("--weights", default=None, help="droid.pth-style checkpoint")
    p.add_argument("--buffer", type=int, default=None)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--disable_backend", action="store_true")
    p.add_argument("--upsample", action="store_true")
    p.add_argument("--reconstruction_path", default=None)
    p.add_argument("--vis_path", default=None,
                   help="stream a live, incrementally-updated PLY here")
    p.add_argument("--bf16", action="store_true", help="bfloat16 network compute")
    p.add_argument("--image_size", type=int, nargs=2, default=None,
                   help="engine H W (streams resize to match)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine: cuda (the default) or cpu")
    for name, typ in [
        ("filter_thresh", float), ("warmup", int), ("keyframe_thresh", float),
        ("frontend_thresh", float), ("frontend_window", int),
        ("frontend_radius", int), ("frontend_nms", int), ("beta", float),
        ("backend_thresh", float), ("backend_radius", int), ("backend_nms", int),
        ("quality_mean_thresh", float), ("quality_min_thresh", float),
    ]:
        p.add_argument(f"--{name}", type=typ, default=None)


def _config_from_args(base, args):
    over = {}
    for f in ("weights", "buffer", "vis_path", "filter_thresh", "warmup", "keyframe_thresh",
              "frontend_thresh", "frontend_window", "frontend_radius",
              "frontend_nms", "beta", "backend_thresh", "backend_radius",
              "backend_nms", "upsample", "quality_mean_thresh",
              "quality_min_thresh"):
        v = getattr(args, f, None)
        if v is not None and v is not False:
            over[f] = v
    if getattr(args, "image_size", None) is not None:
        over["image_size"] = tuple(args.image_size)
    if getattr(args, "bf16", False):
        over["compute_dtype"] = "bfloat16"
    return base.replace(**over)


def _track_stream(droid, stream, use_depth=False, progress=True):
    n = 0
    for item in stream:
        if use_depth and len(item) == 4:
            t, image, depth, intrinsics = item
            droid.track(t, image, depth=depth, intrinsics=intrinsics)
        else:
            t, image, intrinsics = item[0], item[1], item[-1]
            droid.track(t, image, intrinsics=intrinsics)
        n += 1
        if progress and n % 25 == 0:
            print(f"  frame {n}, keyframes {droid.video.counter}", flush=True)
    return n


def _save_trajectory(path, tstamps, traj):
    """TUM-format trajectory file (t tx ty tz qx qy qz qw)."""
    with open(path, "w") as f:
        for t, p in zip(tstamps, traj):
            f.write(f"{t} " + " ".join(f"{x:.9f}" for x in p) + "\n")


def cmd_demo(args):
    from .data import generic_image_stream
    from .utils import DroidConfig

    cfg = _config_from_args(DroidConfig(image_size=(240, 320)), args)
    # probe first frame for actual stream resolution
    probe = next(iter(generic_image_stream(args.imagedir, args.calib, args.stride,
                                           target_area=args.target_area)))
    h, w = probe[1].shape[:2]
    cfg = cfg.replace(image_size=(h, w))

    droid = Droid(cfg, device=args.device)
    stream = generic_image_stream(args.imagedir, args.calib, args.stride,
                                  target_area=args.target_area)
    _track_stream(droid, stream)
    if args.reconstruction_path:
        droid.save_reconstruction(args.reconstruction_path)
    if not args.disable_backend:
        droid.terminate()
    t = droid.video.counter
    print(f"tracked {t} keyframes")
    if args.reconstruction_path:
        droid.save_reconstruction(args.reconstruction_path)
    return droid


def cmd_euroc(args):
    from .data import euroc_stream, euroc_timestamps
    from .eval import evaluate_ate
    from .utils import EUROC_CONFIG

    cfg = _config_from_args(EUROC_CONFIG.replace(stereo=args.stereo), args)
    droid = Droid(cfg, device=args.device)
    stream = euroc_stream(args.datapath, image_size=cfg.image_size,
                          stereo=args.stereo, stride=args.stride)
    _track_stream(droid, stream)

    if args.reconstruction_path:
        # multisession stage 1: session checkpoint + keyframe image export
        # (reference Euroc_Multisession_Stereo/KeyFramesAndRawData.py)
        droid.save_reconstruction(args.reconstruction_path)
        from .multisession.pipeline import extract_images_by_timestamp

        extract_images_by_timestamp(
            os.path.join(args.datapath, "cam0/data"),
            droid.video.tstamp[: droid.video.counter],
            os.path.join(args.reconstruction_path, "keyframes_cam0"),
        )

    fill_stream = (
        (t, im, intr)
        for (t, im, intr) in euroc_stream(
            args.datapath, image_size=cfg.image_size, stereo=args.stereo, stride=args.stride
        )
    )
    traj = droid.terminate_eva(fill_stream)

    tstamps = euroc_timestamps(args.datapath, stride=args.stride)[: len(traj)]
    if args.out:
        _save_trajectory(args.out, tstamps, traj)

    if args.gt:
        # EuRoC ships state_groundtruth_estimate0/data.csv (comma, ns
        # stamps); processed TUM-style files are space-separated
        with open(args.gt) as f:
            head = f.readline()
        delim = "," if head.count(",") > head.count(" ") else None
        gt = np.loadtxt(args.gt, delimiter=delim, comments="#")[:, :8]
        est = np.concatenate(
            [np.asarray(tstamps)[:, None] * 1e-9, traj[:, :3], traj[:, 3:]], axis=1
        )
        if not args.stereo:
            est[:, 1:4] *= 1.10  # mono scale fudge (reference test_euroc.py:134)
        res = evaluate_ate(
            est, gt, align=True, correct_scale=not args.stereo, max_dt=0.1
        )
        print(json.dumps({"ate": res}))
        if args.out:
            with open(args.out + ".ate.json", "w") as f:
                json.dump(res, f)
    return droid


def cmd_tum(args):
    from .data import tum_stream, tum_timestamps
    from .eval import evaluate_ate
    from .utils import TUM_CONFIG

    cfg = _config_from_args(
        TUM_CONFIG.replace(
            filter_thresh=1.75, warmup=12, keyframe_thresh=2.25,
            frontend_thresh=12.0, beta=0.6, backend_thresh=15.0,
            image_size=(240, 320),  # the stream's post-crop size
        ),
        args,
    )
    droid = Droid(cfg, device=args.device)
    _track_stream(droid, tum_stream(args.datapath, stride=2,
                                    image_size=cfg.image_size))
    traj = droid.terminate_eva(
        iter(list(tum_stream(args.datapath, stride=2,
                             image_size=cfg.image_size))))
    print(f"tracked {len(traj)} frames")
    if args.gt:
        gt = np.loadtxt(args.gt)
        # associate by the frames' epoch timestamps (filenames), as the
        # reference's evo protocol does — index association drifts whenever
        # frames were dropped from either stream
        ts = tum_timestamps(args.datapath, stride=2)[: len(traj)]
        if len(ts) < len(traj):
            ts = np.concatenate([ts, np.arange(len(ts), len(traj), dtype=np.float64)])
        est = np.concatenate([ts[:, None], traj[:, :3], traj[:, 3:]], axis=1)
        res = evaluate_ate(est, gt, align=True, correct_scale=True)
        print(json.dumps({"ate": res}))
    return droid


def cmd_eth3d(args):
    from .data import eth3d_stream, eth3d_timestamps
    from .eval import evaluate_ate
    from .utils import ETH3D_CONFIG

    cfg = _config_from_args(ETH3D_CONFIG, args)
    # resize_to_area keeps aspect, so probe the stream for the actual size
    ta = cfg.image_size[0] * cfg.image_size[1]
    probe = next(iter(eth3d_stream(args.datapath, use_depth=args.depth,
                                   target_area=ta)))
    h, w = probe[1].shape[:2]
    cfg = cfg.replace(image_size=(h, w))
    droid = Droid(cfg, device=args.device)
    _track_stream(
        droid, eth3d_stream(args.datapath, use_depth=args.depth,
                            stride=args.stride, target_area=ta),
        use_depth=args.depth,
    )
    traj = droid.terminate_eva(
        iter([(x[0], x[1], x[-1])
              for x in eth3d_stream(args.datapath, stride=args.stride,
                                    target_area=ta)])
    )
    print(f"tracked {len(traj)} frames")

    # ATE vs groundtruth.txt when present (the reference ships the eval
    # commented out, test_eth3d.py:112-118; a new framework should report it)
    gt_file = os.path.join(args.datapath, "groundtruth.txt")
    if os.path.exists(gt_file):
        stamps = np.asarray(eth3d_timestamps(args.datapath, stride=args.stride))
        n = min(len(stamps), len(traj))
        est = np.concatenate(
            [stamps[:n, None], traj[:n, :3], traj[:n, 3:]], axis=1
        )
        gt = np.loadtxt(gt_file, comments="#")
        try:
            res = evaluate_ate(est, gt, max_dt=0.1)
            print(json.dumps({"ate": res}))
        except ValueError as e:
            print(json.dumps({"ate_error": str(e)}))
    return droid


def _tartanair_one(cfg, args, scenedir, gt_file):
    from .data import tartan_stream
    from .eval.metrics import evaluate_tartanair

    stereo, stride = args.stereo, args.stride
    droid = Droid(cfg, device=args.device)
    _track_stream(droid, tartan_stream(scenedir, stereo=stereo, stride=stride,
                                       image_size=cfg.image_size))
    traj = droid.terminate_eva(
        iter([(x[0], x[1][0] if stereo else x[1], x[2])
              for x in tartan_stream(scenedir, stereo=stereo, stride=stride,
                                     image_size=cfg.image_size)])
    )
    res = None
    if gt_file and os.path.exists(gt_file):
        gt = np.loadtxt(gt_file)[:, [1, 2, 0]]  # NED -> xyz translation part
        res = evaluate_tartanair(traj[: len(gt), :3], gt[: len(traj)])
    return droid, res


def cmd_tartanair(args):
    """Single scene, or (--split) the full TartanAir test-split sweep with a
    success-rate curve (reference validate_tartanair.py:77-114)."""
    from .utils import TARTANAIR_CONFIG

    cfg = _config_from_args(TARTANAIR_CONFIG.replace(stereo=args.stereo), args)
    if not args.split:
        droid, res = _tartanair_one(cfg, args, args.datapath, args.gt)
        if res is not None:
            print(json.dumps(res))
        return droid

    from .data import TARTAN_TEST_SPLIT

    scenes = [s for s in TARTAN_TEST_SPLIT
              if os.path.isdir(os.path.join(args.datapath, s))]
    if args.id >= 0:
        scenes = [TARTAN_TEST_SPLIT[args.id]]
    ates = []
    for scene in scenes:
        scenedir = os.path.join(args.datapath, scene)
        gt_file = os.path.join(scenedir, "pose_left.txt")
        print(f"evaluating {scene}", flush=True)
        _, res = _tartanair_one(cfg, args, scenedir, gt_file)
        ate = res["ate_score"] if res else float("nan")
        ates.append(ate)
        print(json.dumps({"scene": scene, "ate": ate}))

    # success-rate curve: fraction of runs under each ATE threshold
    # (reference validate_tartanair.py:106-114 plot, emitted as JSON here)
    ate_arr = np.asarray([a for a in ates if np.isfinite(a)])
    xs = np.linspace(0.0, 1.0, 512)
    curve = [float(np.count_nonzero(ate_arr < t)) / max(len(ate_arr), 1) for t in xs]
    summary = {
        "scenes": len(scenes),
        "mean_ate": float(np.nanmean(ates)) if ates else None,
        "success_rate_curve": {"thresholds": xs.tolist()[::32],
                               "fraction": curve[::32]},
    }
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"per_scene": dict(zip(scenes, ates)), **summary}, f)


def cmd_view(args):
    """Export saved reconstruction(s) as a PLY point cloud, computed on
    ``--device``.

    Multiple --reconstruction paths produce one fused cloud; with
    --color_by_session each map's points are tinted a distinct hue, the
    multi-map viewer behavior of the reference (vis_two.py:1-122,
    s_visualization.py:42-65 hsv session colors)."""
    import colorsys

    from .viz import export_ply, reconstruction_pointcloud

    paths = args.reconstruction
    all_pts, all_cols = [], []
    for i, path in enumerate(paths):
        state = dict(np.load(path, allow_pickle=True))
        pts, cols = reconstruction_pointcloud(state, device=args.device)
        if args.color_by_session and len(paths) > 1:
            tint = np.asarray(colorsys.hsv_to_rgb(i / max(len(paths), 1), 1.0, 1.0))
            cols = 0.4 * cols + 0.6 * tint[None]
        all_pts.append(pts)
        all_cols.append(cols)
        print(f"{path}: {len(pts)} points")
    pts = np.concatenate(all_pts, axis=0)
    cols = np.concatenate(all_cols, axis=0)
    export_ply(args.out, pts, cols)
    print(f"wrote {len(pts)} points to {args.out}")


def cmd_multisession(args):
    """Stages 2+3 of the multisession pipeline over saved session npz files
    (reference Euroc_Multisession_Stereo/{AdjustCoordinates,BackendAllMaps}.py)."""
    import glob

    from .multisession import fuse_maps
    from .utils import EUROC_CONFIG

    cfg = _config_from_args(EUROC_CONFIG.replace(stereo=args.stereo), args)
    params = default_params(cfg)
    states = []
    for p in sorted(glob.glob(os.path.join(args.sessions, "*", "reconstruction.npz"))):
        states.append(dict(np.load(p, allow_pickle=True)))
        print(f"loaded {p}: {len(states[-1]['poses'])} keyframes")
    fused = fuse_maps(cfg, params, states, subsample=args.subsample, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    savez_compressed(os.path.join(args.out, "fused.npz"), **fused)
    print(f"fused map: {len(fused['poses'])} keyframes -> {args.out}/fused.npz")


def cmd_multisession_align(args):
    """Stage 2 / 2v2: align map B into map A's frame via warm-started loop
    replay (reference AdjustCoordinates.py:107-236), optionally through the
    quality-gated ImproveAdjust recovery (reference ImproveAdjust.py:204-337).

    --spec is a JSON file:
      {"groups": [{"seed_idx": [...], "frame_idx": [...], "old_idx": [...],
                   "imagedir": "path", "calib": "calib.txt"}, ...]}
    seed_idx indexes map A's keyframes; frame_idx is the group's matched
    frame ordering (increasing = forward); old_idx indexes map B's keyframes
    (plain align mode).
    """
    from .data import generic_image_stream
    from .multisession import align_pair, joint_backend
    from .multisession.pipeline import improve_adjust
    from .utils import EUROC_CONFIG

    cfg = _config_from_args(EUROC_CONFIG.replace(stereo=args.stereo), args)
    params = default_params(cfg)
    first = dict(np.load(args.first, allow_pickle=True))
    with open(args.spec) as f:
        spec = json.load(f)
    ta = cfg.image_size[0] * cfg.image_size[1]

    def factory(g):
        return lambda: generic_image_stream(g["imagedir"], g["calib"], 1, target_area=ta)

    os.makedirs(args.out, exist_ok=True)
    if args.improve:
        groups = [dict(seed_idx=g["seed_idx"], frame_idx=g["frame_idx"],
                       stream_factory=factory(g), name=g.get("name", i))
                  for i, g in enumerate(spec["groups"])]
        state, report = improve_adjust(cfg, params, first, groups, bad_limit=args.bad_limit,
                                       device=args.device)
        print(json.dumps({"report": report, "recovered": state is not None}))
        if state is not None:
            savez_compressed(os.path.join(args.out, "recovered.npz"), **state)
        return
    if args.second is None:
        raise SystemExit("multisession-align: --second is required unless --improve")
    second = dict(np.load(args.second, allow_pickle=True))
    runs = [(np.asarray(g["seed_idx"]), np.asarray(g["old_idx"]), factory(g))
            for g in spec["groups"]]
    T, new_poses, rows = align_pair(cfg, params, first, second, runs, device=args.device)
    savez_compressed(os.path.join(args.out, "aligned.npz"), T=T, poses=new_poses, rows=rows)
    out = {"T": np.asarray(T).tolist(), "rows": len(rows)}
    if not args.no_joint:
        # stage 2 ends with a joint global backend over the concatenated
        # pair (reference AdjustCoordinates.py:219-229)
        second_t = dict(second)
        second_t["poses"] = np.asarray(new_poses)
        refined = joint_backend(cfg, params, [first, second_t], device=args.device)
        savez_compressed(os.path.join(args.out, "aligned_joint.npz"),
                            poses_first=refined[0], poses_second=refined[1], T=T)
        out["joint"] = "aligned_joint.npz"
    print(json.dumps(out))


def cmd_multisession_evaluate(args):
    """Stage 4 (reference Whole_Evaluate.py:142-225): per-sequence pose fill
    from the fused map, concatenated ATE vs concatenated groundtruth.

    --spec JSON: {"sequences": [{"start": a, "stop": b, "imagedir": ...,
                                 "calib": ..., "gt": "file.txt"}, ...]}
    """
    from .data import generic_image_stream
    from .multisession import evaluate_fused_map
    from .utils import EUROC_CONFIG

    cfg = _config_from_args(EUROC_CONFIG.replace(stereo=args.stereo), args)
    params = default_params(cfg)
    fused = dict(np.load(args.fused, allow_pickle=True))
    with open(args.spec) as f:
        spec = json.load(f)
    slices = [(s["start"], s["stop"]) for s in spec["sequences"]]
    ta = cfg.image_size[0] * cfg.image_size[1]
    streams = [(lambda s=s: generic_image_stream(s["imagedir"], s["calib"], 1, target_area=ta))
               for s in spec["sequences"]]
    gts = None
    if all("gt" in s for s in spec["sequences"]):
        gts = [np.loadtxt(s["gt"]) for s in spec["sequences"]]
    trajs, res = evaluate_fused_map(cfg, params, fused, slices, streams, gts=gts,
                                    correct_scale=not args.stereo, device=args.device)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for i, tr in enumerate(trajs):
            np.save(os.path.join(args.out, f"traj_{i}.npy"), tr)
    print(json.dumps({"ate": res, "sequences": len(trajs)}))


def cmd_train(args):
    """The training loop (reference train.py:43-186): per item a sampled
    graph (covisibility or temporal, 1/2 each), random pose restarts whose
    gradients are summed before one optimizer step, and a producer thread
    that prepares the items.  The numpy seeds are derived from the step
    index, so a resumed run replays the data of an uninterrupted one.

    Several processes (one per card, joined by ``parallel.init_distributed``
    from the ``DROID_*`` variables) train data-parallel: each rank draws
    cfg.batch items of its own (seeds (54321, rank, t); the global batch is
    cfg.batch x world), takes rank 0's graph, shares the restart draws,
    scales its loss by 1 / world and sums the gradients over the ranks
    before the step (the global batch's gradient; see
    train.step.grads_and_aux); rank 0 alone logs and writes checkpoints.
    At world size 1 the loop computes what a single process does, bit for
    bit."""
    import queue
    import threading

    import torch
    import torch.distributed as dist

    from .data import dataset_factory
    from .lie import se3_inv
    from .parallel import allreduce, backend_for, init_distributed, rank_device
    from .train import Logger, TrainConfig, init_train_state, load_ckpt, save_ckpt
    from .train.step import initial_poses, make_train_step_dynamic, sample_frame_graph

    rank, world = init_distributed(backend=backend_for(args.device))
    grouped = dist.is_initialized()
    device = rank_device(args.device)
    crop = tuple(args.image_size)
    cfg = TrainConfig(name=args.name, lr=args.lr, steps=args.steps, batch=args.batch,
                      n_frames=args.n_frames, iters=args.iters, image_size=crop)
    if rank == 0:
        os.makedirs("checkpoints", exist_ok=True)

    # the scene-index cache lives under the dataset root, so different
    # datasets never share a stale pickle; rank 0 writes it before the
    # others read it
    def make_db():
        return dataset_factory(["tartan"], datapath=args.datapath, n_frames=cfg.n_frames,
                               fmin=cfg.fmin, fmax=cfg.fmax, crop_size=crop,
                               cache_dir=os.path.join(args.datapath, ".droid_cache"),
                               device=device)

    db = make_db() if rank == 0 else None
    if world > 1:
        dist.barrier()
    db = db or make_db()
    # each rank's share of the global batch's loss; the gradients are summed
    grad_step, apply_step = make_train_step_dynamic(cfg, loss_scale=1.0 / world)

    params, opt_state = init_train_state(cfg, device=device)
    start_step = 0
    if args.ckpt:
        params, opt2, start_step = load_ckpt(args.ckpt, device)
        if opt2 is not None:
            opt_state = opt2
    logger = Logger(cfg.name) if rank == 0 else None
    # covers the r=2 temporal graph and the covisibility sampler's 24 edges
    e_pad = max(4 * cfg.n_frames, 24)

    q = queue.Queue(maxsize=4)
    stop = threading.Event()

    def producer():
        t = start_step
        try:
            while not stop.is_set():
                prng = np.random.default_rng((54321, rank, t))
                grng = np.random.default_rng((98765, t))
                items = [db[int(i)] for i in prng.integers(0, len(db), size=cfg.batch)]
                images, poses, disps, intr = (np.stack([x[k] for x in items]) for k in range(4))
                ii, jj, emask = sample_frame_graph(grng, poses, disps, intr, cfg.n_frames, e_pad,
                                                   device=device)
                t += 1
                while not stop.is_set():
                    try:
                        q.put((images, poses, disps, intr, ii, jj, emask), timeout=5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # the main loop raises it
            q.put(e)
            raise

    th = threading.Thread(target=producer, daemon=True)
    th.start()

    def next_item():
        while True:
            try:
                item = q.get(timeout=10)
            except queue.Empty:
                if not th.is_alive():
                    raise RuntimeError("data producer thread died")
                continue
            if isinstance(item, BaseException):
                raise RuntimeError("data producer failed") from item
            return item

    def put(x, dtype=torch.float32):
        return torch.from_numpy(np.asarray(x)).to(device=device, dtype=dtype)

    total = start_step
    try:
        while total < cfg.steps:
            images, poses, disps, intr, ii, jj, emask = next_item()
            rng = np.random.default_rng((12345, total))   # the same draws on every rank
            poses, disps = put(poses), put(disps)
            ii, jj, emask = put(ii, torch.long), put(jj, torch.long), put(emask)
            if world > 1:
                # one graph per global batch: the covisibility graph depends
                # on local data, so every rank takes rank 0's
                for x in (ii, jj, emask):
                    dist.broadcast(x, src=0)
            batch = {"images": put(images), "poses": poses, "disps": disps,
                     "intrinsics": put(intr), "ii": ii, "jj": jj, "emask": emask,
                     "Gs0": initial_poses(se3_inv(poses)),
                     "disp0": torch.ones_like(disps[:, :, 3::8, 3::8])}

            # restarts (reference train.py:102-118): at least one pass, the
            # gradients summed, the next pass seeded with the last estimate
            grads_acc = None
            while True:
                grads, metrics, (Gs_last, disp_last) = grad_step(params, batch)
                grads_acc = grads if grads_acc is None else {
                    k: grads_acc[k] + g for k, g in grads.items()}
                batch = dict(batch, Gs0=Gs_last, disp0=disp_last)
                if rng.random() >= args.restart_prob:
                    break
            if grouped:
                grads_acc = allreduce(grads_acc, None)
                metrics = allreduce(metrics, None, world)
            params, opt_state = apply_step(params, opt_state, grads_acc)

            values = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=device)
                                  for v in metrics.values()]).cpu().tolist()
            total += 1
            if rank == 0:
                logger.push(dict(zip(metrics, values)))
                if total % args.save_every == 0:
                    save_ckpt(f"checkpoints/{cfg.name}_{total:06d}.npz", params, opt_state,
                              total)
    finally:
        stop.set()


def build_parser():
    parser = argparse.ArgumentParser(prog="droid_slam_reserch_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("demo")
    p.add_argument("--imagedir", required=True)
    p.add_argument("--calib", required=True)
    p.add_argument("--target_area", type=int, default=384 * 512,
                   help="resize frames so h*w ~= this (reference demo.py:66)")
    _add_slam_flags(p)
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("euroc")
    p.add_argument("--datapath", required=True)
    p.add_argument("--gt", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--stereo", action="store_true")
    _add_slam_flags(p)
    p.set_defaults(fn=cmd_euroc)

    p = sub.add_parser("tum")
    p.add_argument("--datapath", required=True)
    p.add_argument("--gt", default=None)
    _add_slam_flags(p)
    p.set_defaults(fn=cmd_tum)

    p = sub.add_parser("eth3d")
    p.add_argument("--datapath", required=True)
    p.add_argument("--depth", action="store_true")
    _add_slam_flags(p)
    p.set_defaults(fn=cmd_eth3d)

    p = sub.add_parser("tartanair")
    p.add_argument("--datapath", required=True)
    p.add_argument("--gt", default=None)
    p.add_argument("--stereo", action="store_true")
    p.add_argument("--split", action="store_true",
                   help="sweep the TartanAir test split + success-rate curve")
    p.add_argument("--id", type=int, default=-1, help="single split scene index")
    p.add_argument("--out", default=None, help="JSON results path (--split)")
    _add_slam_flags(p)
    p.set_defaults(fn=cmd_tartanair)

    p = sub.add_parser("view")
    p.add_argument("--reconstruction", required=True, nargs="+",
                   help="one or more reconstruction.npz (multi-map fusion)")
    p.add_argument("--out", default="cloud.ply")
    p.add_argument("--color_by_session", action="store_true",
                   help="tint each map a distinct hue (reference vis_two.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the point cloud: cuda (the default) or cpu")
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("multisession")
    p.add_argument("--sessions", required=True, help="dir of session subdirs")
    p.add_argument("--out", required=True)
    p.add_argument("--stereo", action="store_true")
    p.add_argument("--subsample", type=int, default=2)
    _add_slam_flags(p)
    p.set_defaults(fn=cmd_multisession)

    p = sub.add_parser("multisession-align")
    p.add_argument("--first", required=True, help="map A reconstruction.npz")
    p.add_argument("--second", default=None, help="map B reconstruction.npz")
    p.add_argument("--spec", required=True, help="loop-group JSON spec")
    p.add_argument("--out", required=True)
    p.add_argument("--stereo", action="store_true")
    p.add_argument("--improve", action="store_true",
                   help="quality-gated ImproveAdjust recovery")
    p.add_argument("--bad_limit", type=int, default=4)
    p.add_argument("--no_joint", action="store_true",
                   help="skip the joint global backend over the aligned pair "
                        "(reference AdjustCoordinates.py:219-229)")
    _add_slam_flags(p)
    p.set_defaults(fn=cmd_multisession_align)

    p = sub.add_parser("multisession-evaluate")
    p.add_argument("--fused", required=True, help="fused.npz")
    p.add_argument("--spec", required=True, help="sequence JSON spec")
    p.add_argument("--out", default=None)
    p.add_argument("--stereo", action="store_true")
    _add_slam_flags(p)
    p.set_defaults(fn=cmd_multisession_evaluate)

    p = sub.add_parser("train")
    p.add_argument("--datapath", required=True)
    p.add_argument("--ckpt", default=None, help="npz checkpoint to resume from")
    p.add_argument("--save_every", type=int, default=10000,
                   help="checkpoint every N steps (params + optimizer state + step)")
    p.add_argument("--name", default="droid")
    p.add_argument("--lr", type=float, default=2.5e-4)
    p.add_argument("--steps", type=int, default=250000)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--n_frames", type=int, default=7)
    p.add_argument("--iters", type=int, default=15)
    p.add_argument("--image_size", type=int, nargs=2, default=[384, 512],
                   help="training crop H W (reference augmentation crop)")
    p.add_argument("--restart_prob", type=float, default=0.2,
                   help="random pose-restart probability (reference train.py:102)")
    p.add_argument("--device", default="cuda",
                   help="torch device of training: cuda (the default) or cpu")
    p.set_defaults(fn=cmd_train)
    return parser


def main(argv=None):
    """Run one command; returns the tracking command's Droid (None for a
    --split sweep and for the view and multisession commands), which
    ``python -m`` does not use."""
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
