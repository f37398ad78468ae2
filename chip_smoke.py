#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each; any failure exits nonzero):
1. build   nvcc-compiles the port's CUDA kernels from csrc/ (sm_90a);
2. kernels holds each kernel (K1 BA blocks, K2 correlation build, K3
           correlation lookup) against its plain PyTorch version on the card
           at the main path's shapes, and times kernel, plain version and,
           where one PyTorch call computes the same function, that call;
3. card vs CPU  the oracle frontend gate on the card (ATE < 0.01), and the
           port's Droid.track at 64x96 on the card against the same run with
           device="cpu";
4. main path    Droid.track with EUROC_CONFIG (mono, 320x512, fp32, full
           network widths, seeded random weights) over synthetic frames, with
           every kernel's launch count and every plain version's call count
           set to 0 just before and read just after.
Then it prints the card's name and power limit, one JSON line describing
the kernels, and as its last line the device JSON.  The script needs only
torch, numpy and scipy, and the CUDA toolkit for nvcc.

    python3 chip_smoke.py --profile

adds a phase after the main path: 12 more keyframes, half of them timed
per stage on the host clock and half under torch.profiler, with the device
kernel time grouped and the device's idle share printed; the full tables go
to chiprun_out/profile_main_path.txt.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# main-path shapes: EuRoC 320x512 -> 40x64 feature maps, 48 active edges
E_MAIN, H8, W8, C = 48, 40, 64, 128
N_BA, MW_BA = 64, 24           # 48 active + 16 inactive edges over a 24-frame window
K1_OPS_PER_PIXEL = 580         # flops per pixel, counted from csrc/ba_blocks.cu


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(torch, fn, reps, warmup=2, device_only=True):
    """Mean time of fn from CUDA events around `reps` calls.

    device_only: a sleep kernel holds the stream while the host enqueues
    all `reps` calls, so the events time the device's work back to back and
    not the host's Python.  Until the sleep outlasts the enqueue it is
    doubled and `reps` halved: the driver's queue of pending launches is
    finite, and a host that fills it waits for the sleep.  Without
    device_only the time is that of the call as a caller sees it, host
    overhead included.
    """
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 50_000_000
    for _ in range(8):
        torch.cuda.synchronize()
        if device_only:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()       # the sleep still ran when the enqueue ended
        torch.cuda.synchronize()
        if held or not device_only:
            return start.elapsed_time(end) / reps
        cycles *= 2
        reps = max(1, reps // 2)
    fail("could not hold the stream long enough to time the device alone")


def synth_small(t, rng, H=64, W=96):
    """The JAX package's engine-test frame: a textured pattern translating."""
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    img = (127 + 80 * np.sin(0.2 * (xs + 6 * t)) * np.cos(0.15 * (ys + 3 * t))
           + 20 * rng.standard_normal((H, W)))
    return np.clip(img, 0, 255).astype(np.uint8)[..., None].repeat(3, -1)


def small_config(DroidConfig):
    return DroidConfig(
        image_size=(64, 96), buffer=32, warmup=5, filter_thresh=-1.0,
        frontend_window=8, frontend_thresh=32.0, max_factors=32, keyframe_thresh=0.0,
        init_iters=2, iters1=1, iters2=1, edge_bucket=8, window_bucket=4,
    )


def euroc_frames(n, seed=0, H=320, W=512, step=4):
    """Smoothed random texture panning `step` px per frame, 3-channel uint8."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.RandomState(seed)
    base = gaussian_filter(rng.rand(H + 8, W + step * n + 8), 2.0)
    base = (base - base.min()) / (base.max() - base.min()) * 255.0
    return [np.repeat(base[4:4 + H, 4 + step * t: 4 + step * t + W, None], 3, -1).astype(np.uint8)
            for t in range(n)]


def bound(ops, nbytes):
    """Least time in ms for `ops` fp32 operations and `nbytes` moved, and
    which of the two sets it."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def phase_kernels(torch):
    from droid_slam_reserch_tpu_torch.geom import coords_grid
    from droid_slam_reserch_tpu_torch.lie import se3_exp
    from droid_slam_reserch_tpu_torch.ops import cuda_ba, cuda_corr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    # ---- K2 / K3 at E = 48 (frontend) and E = 1 (motion filter)
    P = Q = H8 * W8
    for E in (E_MAIN, 1):
        f1 = randn(E, H8, W8, C)
        f2 = randn(E, H8, W8, C)
        levels = cuda_corr.corr_build(f1, f2)
        plain = cuda_corr.corr_build_plain(f1, f2)
        torch.cuda.synchronize()
        err2 = max(float((a - b).abs().max()) for a, b in zip(levels, plain))
        scale2 = float(plain[0].abs().max())
        tol2 = 1e-5 * max(1.0, scale2)
        say("kernels", f"K2 corr_build E={E}: max_abs_err {err2:.3e} (tol {tol2:.1e}, "
                       f"|level0| max {scale2:.2f})")
        if not err2 <= tol2:
            fail(f"K2 disagrees with its plain version at E={E}")
        del plain

        grid = coords_grid(H8, W8, device=dev).reshape(1, P, 2)
        coords = (grid + randn(E, P, 2, scale=2.0)).contiguous()
        coords[:, :64] += 50.0                     # some lookups far off the image
        out = cuda_corr.corr_lookup(levels, coords)
        ref = cuda_corr.corr_lookup_plain(levels, coords)
        torch.cuda.synchronize()
        err3 = float((out - ref).abs().max())
        tol3 = 1e-5 * max(1.0, float(ref.abs().max()))
        say("kernels", f"K3 corr_lookup E={E}: max_abs_err {err3:.3e} (tol {tol3:.1e})")
        if not err3 <= tol3:
            fail(f"K3 disagrees with its plain version at E={E}")
        del ref

        reps = 10 if E == E_MAIN else 50
        ms2 = cuda_ms(torch, lambda: cuda_corr.corr_build(f1, f2), reps)
        plain_ms2 = cuda_ms(torch, lambda: cuda_corr.corr_build_plain(f1, f2), max(reps // 5, 2))
        a, b = f1.reshape(E, P, C), f2.reshape(E, Q, C).transpose(1, 2)
        lib_ms2 = cuda_ms(torch, lambda: torch.bmm(a, b), reps)
        bound2 = bound(2.0 * E * P * Q * C,
                       (f1.numel() + f2.numel() + sum(v.numel() for v in levels)) * 4)

        ms3 = cuda_ms(torch, lambda: cuda_corr.corr_lookup(levels, coords), 4 * reps)
        plain_ms3 = cuda_ms(torch, lambda: cuda_corr.corr_lookup_plain(levels, coords),
                            max(reps // 5, 2))
        # bytes this run's data needs: the in-bounds cells of every 8x8 window
        need = 0
        off = torch.arange(-3, 5, device=dev)
        for l, v in enumerate(levels):
            h, w = v.shape[-2:]
            c = coords / 2 ** l
            ys = torch.floor(c[..., 1:2]).long() + off
            xs = torch.floor(c[..., 0:1]).long() + off
            need += int((((ys >= 0) & (ys < h)).sum(-1) * ((xs >= 0) & (xs < w)).sum(-1)).sum())
        bound3 = bound(E * P * 4 * (7 * 8 * 3 + 49 * 3),
                       (need + coords.numel() + out.numel()) * 4)
        say("kernels", f"E={E}: K2 {ms2:.4f} ms (plain {plain_ms2:.4f}, torch.bmm volume "
                       f"{lib_ms2:.4f}, bound {bound2[0]:.4f} by {bound2[1]}); K3 {ms3:.4f} ms "
                       f"(plain {plain_ms3:.4f}, bound {bound3[0]:.4f} by {bound3[1]})")
        if E == E_MAIN:
            rows["corr_build"] = dict(max_abs_err=err2, ms=ms2, plain_ms=plain_ms2,
                                      library_ms=lib_ms2, bound_ms=bound2[0], bound_by=bound2[1])
            rows["corr_lookup"] = dict(max_abs_err=err3, ms=ms3, plain_ms=plain_ms3,
                                       library_ms=None, bound_ms=bound3[0], bound_by=bound3[1])
        del levels, out

    # ---- K1 at N = 64 edges over a 24-frame window
    xi = torch.cat([0.05 * torch.arange(MW_BA, device=dev)[:, None].expand(MW_BA, 3),
                    randn(MW_BA, 3, scale=0.01)], 1)
    poses = se3_exp(xi)
    disps = (0.5 + torch.rand(MW_BA, H8, W8, generator=gen, device=dev)).contiguous()
    intr = torch.tensor([296.3 / 8, 290.1 / 8, 250.2 / 8, 168.1 / 8], device=dev)
    ii = torch.randint(0, MW_BA, (N_BA,), generator=gen, device=dev)
    jj = (ii + torch.randint(1, 4, (N_BA,), generator=gen, device=dev)) % MW_BA
    ii[-4:] = 0
    jj[-4:] = 0                                  # padding edges, as the engine pads
    grid = coords_grid(H8, W8, device=dev)
    target = (grid + randn(N_BA, H8, W8, 2, scale=1.5)).contiguous()
    weight = torch.rand(N_BA, H8, W8, 2, generator=gen, device=dev)
    args = (target, weight, poses, disps, intr, ii, jj)
    out = cuda_ba.ba_system_blocks(*args)
    ref = cuda_ba.build_system_blocks(*args)
    torch.cuda.synchronize()
    err1, ok1 = 0.0, True
    for k in ref:
        d = float((out[k] - ref[k]).abs().max())
        err1 = max(err1, d)
        ok1 &= d <= 2e-4 * max(1.0, float(ref[k].abs().max()))
    say("kernels", f"K1 ba_blocks N={N_BA}: max_abs_err {err1:.3e} "
                   f"(tol 2e-4*max(1,|ref|) per output)")
    if not ok1:
        fail("K1 disagrees with its plain version")
    kin = cuda_ba.edge_inputs(poses, intr, ii, jj)
    ms1 = cuda_ms(torch, lambda: cuda_ba.launch(target, weight, *kin, disps), 50)
    wrapper_ms1 = cuda_ms(torch, lambda: cuda_ba.ba_system_blocks(*args), 50)
    call_ms1 = cuda_ms(torch, lambda: cuda_ba.ba_system_blocks(*args), 50, device_only=False)
    plain_ms1 = cuda_ms(torch, lambda: cuda_ba.build_system_blocks(*args), 10)
    HW = H8 * W8
    # reads target, weight, disps and gij once; writes H, v, E, C and w once
    bound1 = bound(N_BA * HW * K1_OPS_PER_PIXEL,
                   (N_BA * HW * 4 + MW_BA * HW + N_BA * 12
                    + N_BA * (144 + 12) + N_BA * 12 * HW + N_BA * HW * 2) * 4)
    rows["ba_blocks"] = dict(max_abs_err=err1, ms=ms1, plain_ms=plain_ms1, library_ms=None,
                             bound_ms=bound1[0], bound_by=bound1[1])
    say("kernels", f"K1 {ms1:.4f} ms launch alone, {wrapper_ms1:.4f} ms with the wrapper's "
                   f"Gij on the device, {call_ms1:.4f} ms per call as the host sees it "
                   f"(plain {plain_ms1:.4f}, bound {bound1[0]:.4f} by {bound1[1]})")
    return rows


def phase_card_vs_cpu(torch, ops):
    from droid_slam_reserch_tpu_torch.engine import Droid
    from droid_slam_reserch_tpu_torch.eval import oracle
    from droid_slam_reserch_tpu_torch.eval.metrics import ate_rmse
    from droid_slam_reserch_tpu_torch.models import init_params
    from droid_slam_reserch_tpu_torch.utils import DroidConfig

    ops.reset_counts()
    gt = oracle.gt_scene()
    v, front = oracle.drive_frontend(gt, device="cuda")
    torch.cuda.synchronize()
    counts = ops.counts()
    err, _ = ate_rmse(oracle.cam_centers(v.poses[:oracle.T]), oracle.cam_centers(gt[0]),
                      align=True, correct_scale=True)
    say("card-vs-cpu", f"oracle frontend gate on the card: ATE {err:.3e} (limit 1e-2), "
                       f"keyframes {v.counter}, launches {counts}")
    if not (err < 0.01 and v.counter == oracle.T):
        fail("oracle frontend gate on the card")
    if any(n == 0 or p != 0 for n, p in counts.values()):
        fail(f"oracle gate did not run through every kernel: {counts}")

    params = init_params(seed=0)
    runs = {}
    for device in ("cuda", "cpu"):
        d = Droid(small_config(DroidConfig), params=params, device=device)
        rng = np.random.RandomState(0)
        hist = []
        for t in range(10):
            d.track(float(t), synth_small(t, rng),
                    intrinsics=np.array([60.0, 60.0, 48.0, 32.0], np.float32))
            hist.append((d.video.counter, d.frontend.graph.ii.copy(), d.frontend.graph.jj.copy()))
        runs[device] = (hist, d.video.poses[:d.video.counter].cpu().numpy())
    (h_gpu, p_gpu), (h_cpu, p_cpu) = runs["cuda"], runs["cpu"]
    same_graph = all(a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
                     for a, b in zip(h_gpu, h_cpu))
    dp = float(np.abs(p_gpu - p_cpu).max()) if p_gpu.shape == p_cpu.shape else float("inf")
    say("card-vs-cpu", f"Droid.track 64x96, 10 frames: keyframes {h_gpu[-1][0]} vs "
                       f"{h_cpu[-1][0]}, edges equal every frame: {same_graph}, "
                       f"max |pose diff| {dp:.3e} (tol 1e-3)")
    if not (same_graph and dp <= 1e-3):
        fail("the card run and the CPU run of Droid.track disagree")


def phase_main_path(torch, ops, n_frames=40, extra=0):
    from droid_slam_reserch_tpu_torch.engine import Droid
    from droid_slam_reserch_tpu_torch.utils import EUROC_CONFIG

    cfg = EUROC_CONFIG.replace(filter_thresh=-1.0, keyframe_thresh=0.0)
    frames = euroc_frames(n_frames + extra)
    intr = np.array([296.3, 290.1, 250.2, 168.1], np.float32)
    droid = Droid(cfg, device="cuda")
    torch.cuda.synchronize()

    ops.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    t_init = None
    for t, img in enumerate(frames[:n_frames]):
        droid.track(float(t), img, intrinsics=intr)
        if t_init is None and droid.frontend.is_initialized:
            torch.cuda.synchronize()
            t_init = (time.time(), t + 1)
    torch.cuda.synchronize()
    t1 = time.time()
    counts = ops.counts()
    if t_init is None:
        fail("the frontend never initialised on the main path")

    v = droid.video
    n_kf = v.counter
    poses, disps = v.poses[:n_kf], v.disps[:n_kf]
    finite = bool(torch.isfinite(poses).all() and torch.isfinite(disps).all())
    steady = n_frames - t_init[1]
    fps_all = n_frames / (t1 - t0)
    fps_steady = steady / (t1 - t_init[0]) if steady > 0 else float("nan")
    say("main-path", f"EUROC_CONFIG mono 320x512 fp32: {n_frames} frames, {n_kf} keyframes, "
                     f"{len(droid.frontend.graph.ii)} active edges; {fps_all:.2f} frames/s and "
                     f"{n_kf / (t1 - t0):.2f} keyframes/s overall, {fps_steady:.2f} frames/s "
                     f"after initialisation; peak memory "
                     f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say("main-path", f"counts (kernel launches, plain calls): {counts}")
    if not finite:
        fail("non-finite poses or disparities on the main path")
    if n_kf < cfg.warmup:
        fail(f"only {n_kf} keyframes (< warmup {cfg.warmup})")
    for name, (launches, plain) in counts.items():
        if launches == 0 or plain != 0:
            fail(f"{name}: {launches} kernel launches, {plain} plain calls on the main path")
    return counts, droid, frames[n_frames:], intr


KERNEL_GROUPS = (      # substrings of device kernel names -> group, first match wins
    ("port K2 corr_build", ("corr_volume_kernel", "pool2x_kernel")),
    ("port K3 corr_lookup", ("corr_lookup_kernel",)),
    ("port K1 ba_blocks", ("ba_blocks_kernel",)),
    ("convolutions (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "winograd", "fft", "_complex")),
    ("matrix products (cuBLAS)", ("gemm", "gemv", "cutlass")),
    ("Cholesky (cuSOLVER)", ("potrf", "potrs", "trsm", "cholesky", "syrk")),
    ("copies and fills", ("memcpy", "memset", "copy", "fill")),
)


def phase_profile(torch, droid, frames, intr):
    """Where a steady-state keyframe's time goes, after the main path.

    The first half of `frames` is tracked with the motion filter and the
    frontend timed apart on the host clock (each ends in a synchronize);
    the second half runs Droid.track under torch.profiler, whose device
    kernels are summed by name and by group against the wall time.  The
    full tables go to chiprun_out/profile_main_path.txt.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    half = len(frames) // 2
    t_base = float(droid.video.tstamp[droid.video.counter - 1]) + 1.0
    mf, fe = [], []
    with torch.no_grad():
        for k, img in enumerate(frames[:half]):
            t0 = time.perf_counter()
            droid.filterx.track(t_base + k, img, None, intr)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            droid.frontend()
            torch.cuda.synchronize()
            mf.append(t1 - t0)
            fe.append(time.perf_counter() - t1)
    say("profile", f"{half} keyframes on the host clock: motion filter "
                   f"{1e3 * np.mean(mf):.1f} ms, frontend {1e3 * np.mean(fe):.1f} ms per keyframe "
                   f"(median {1e3 * np.median(fe):.1f})")

    rest = frames[half:]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k, img in enumerate(rest):
            droid.track(t_base + half + k, img, intrinsics=intr)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    avgs = prof.key_averages()
    dev = sorted(((e.self_device_time_total, e.count, e.key) for e in avgs
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                 reverse=True)
    busy_us = sum(us for us, _, _ in dev)
    if busy_us == 0:
        fail("torch.profiler recorded no device time")
    groups = {}
    for us, _, name in dev:
        low = name.lower()
        g = next((g for g, keys in KERNEL_GROUPS if any(s in low for s in keys)), "other kernels")
        groups[g] = groups.get(g, 0.0) + us
    say("profile", f"{len(rest)} keyframes under torch.profiler: wall {wall_us / 1e3 / len(rest):.1f} "
                   f"ms per keyframe, device busy {busy_us / 1e3 / len(rest):.1f} ms "
                   f"({100 * busy_us / wall_us:.1f} %), idle {100 * (1 - busy_us / wall_us):.1f} %")
    say("profile", "device time per keyframe by group: " + "; ".join(
        f"{g} {us / 1e3 / len(rest):.2f} ms" for g, us in sorted(groups.items(), key=lambda x: -x[1])))
    path = os.path.join(OUT_DIR, "profile_main_path.txt")
    with open(path, "w") as f:
        f.write(f"{len(rest)} keyframes, wall {wall_us:.0f} us, device busy {busy_us:.0f} us\n\n")
        f.write("device kernels by total time (us, count, name):\n")
        for us, n, name in dev:
            f.write(f"{us:12.1f} {n:7d}  {name[:160]}\n")
        f.write("\n" + avgs.table(sort_by="self_cpu_time_total", row_limit=40))
    say("profile", f"tables in {os.path.relpath(path, REPO)}")


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a CUDA card")
    if not os.path.isdir(os.path.join(REPO, "droid_slam_reserch_tpu_torch", "csrc")):
        fail("run from a checkout of the repository: droid_slam_reserch_tpu_torch/ is missing")
    sys.path.insert(0, REPO)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)

    from droid_slam_reserch_tpu_torch import ops
    from droid_slam_reserch_tpu_torch.ops import build

    t0 = time.time()
    build.build(ptxas_verbose=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        f.write(build.BUILD_LOG["ptxas"])
    say("build", f"nvcc sm_90a, {len(os.listdir(build.CSRC))} sources in parallel: "
                 f"{time.time() - t0:.1f} s ({build.LIB_PATH})")
    build.library()

    profiling = "--profile" in sys.argv[1:]
    rows = phase_kernels(torch)
    phase_card_vs_cpu(torch, ops)
    counts, droid, extra, intr = phase_main_path(torch, ops, extra=12 if profiling else 0)
    if profiling:
        phase_profile(torch, droid, extra, intr)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output",
          flush=True)

    meta = {
        "ba_blocks": ("droid_slam_reserch_tpu_torch/csrc/ba_blocks.cu",
                      "droid_slam_reserch_tpu/ops/pallas_ba.py:139"),
        "corr_build": ("droid_slam_reserch_tpu_torch/csrc/corr_build.cu",
                       "droid_slam_reserch_tpu/ops/pallas_corr.py:182"),
        "corr_lookup": ("droid_slam_reserch_tpu_torch/csrc/corr_lookup.cu",
                        "droid_slam_reserch_tpu/ops/pallas_corr.py:265"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": counts[name][0], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
