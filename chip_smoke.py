#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each; any failure exits nonzero):
1. build   nvcc-compiles the port's CUDA kernels from csrc/ (sm_90a), one
           process per source, all started together, and g++ the port's C++
           graph library (csrc/graph_ops.cpp: edge selection, dedup, Schur
           bucket tables);
2. kernels prints what ptxas made of the correlation build (K2), the BA
           blocks (K1), the window-cache build (K4, K8), the windowed lookup
           (K5), the pyramid lookups (K3, K6) and the window extraction (K7)
           and K4's occupancy; holds
           each kernel (K1 BA blocks, K2 correlation build, K3 correlation
           lookup, K4 window-cache build, K5 windowed lookup, K6 P-major
           lookup, K7 window extraction, K8 build of levels and windows)
           against its plain PyTorch version on the card at the main path's
           shapes (K2-K6 and K8 also at a ragged 30x44 and at 60x80, K2 and K3
           also at the backend's 64 edges, K2 also on a 48x120 map wider than
           K4 takes; K3 and K6 with random coords and with a smooth 4-px pan;
           K1 at 64 edges, at 1, and on a batch with stereo self-edges),
           K5(K4) against K3(K2) where the drift rule holds, K6 against K3, K7
           and K8 against K2 and K4, and times kernel, plain version and,
           where one PyTorch call computes the same function, that call
           (torch.bmm for the builds, F.grid_sample bilinear for the lookups,
           F.grid_sample nearest for K7's window extraction); the lookups'
           and K7's bound also by the 32-byte sectors their span rows (K7:
           window rows inside the levels) touch (sector_bound_ms);
   kernels-bf16  the same for the bf16 instantiations of K2 (bf16 levels and
           fp32 levels), K3, K4, K5, K6, K7 and K8, with their ptxas reports,
           at E = 48, E = 1, K2 also at EB = 64, all also at 30x44, 60x80,
           30x45, 24x34, 24x66, 27x45 (odd P) and on the 48x120 map (K4 and
           K8 in bf16 take maps up to 181 cells wide); K6 and K7 exactly, K8's
           windows exactly against K7 over K8's own levels, and the cells in
           which K3 and K5 differ from their plain versions; the yardsticks take bf16
           (torch.bmm of the bf16 volume, or from bf16 to an fp32 volume for
           K2's fp32 levels, F.grid_sample on bf16 levels); K2 bf16's
           persistent grid is printed;
3. drift   the frontend's windowed lookup with coords that leave the cached
           windows, in fp32 and in bf16: the fallback (K2 once, K3) is taken,
           counted and equal to the plain full lookup;
4. card vs CPU  the oracle frontend and backend gates on the card (ATE <
           0.01), and the port's Droid.track + terminate_eva at 64x96 on the
           card against the same run with device="cpu": mono, stereo,
           RGB-D, mono with cfg.upsample (disps_up compared too) and mono
           with ba_shards=2 and refresh_shards=2 in fp32, mono and stereo in
           bf16;
5. main path    Droid.track with EUROC_CONFIG (mono, 320x512, full network
           widths, seeded random weights) over synthetic frames, then
           Droid.terminate_eva over the same frames (backend 7 + 12 steps,
           trajectory filler), in fp32 and then with compute_dtype="bfloat16";
           the same with EUROC_CONFIG.replace(stereo=True) over stereo pairs
           of the panned texture (the right view 6 px along), and with
           ETH3D_CONFIG (RGB-D, 480x640) over 32 frames and a smooth seeded
           depth, in bf16 and then fp32; before each track and terminate_eva,
           every kernel's launch count and every plain version's call count
           is set to 0, and read just after, and so are the graph library's
           (its three entry points called, their numpy versions not); then
           the library held against its numpy version on the fp32 mono
           path's last frontend and first backend selections, and both timed
           there and on a 512-keyframe backend matrix (graph_library.json in
           chiprun_out/); then K1 held at the largest
           edge count of the fp32 mono and stereo backends' graphs, and on the
           stereo and RGB-D paths every kernel held against its plain version
           on the inputs of the engine's last call of it in the track and in
           the backend (`[engine-inputs]`);
   cli     the port's CLI (cli.main, in process) on datasets written as
           PNGs into a temporary directory: EuRoC (752x480 grey, 40 frames,
           stereo), TUM fr1, ETH3D (RGB-D), TartanAir and a demo directory;
           euroc mono with --upsample --out --gt in fp32 and bf16 (the
           multisession phase runs --reconstruction_path), euroc --stereo,
           tum, eth3d --depth, tartanair and demo in bf16; per command the
           counts are set to 0 before and read after (K1-K5 of the dtype
           launch, no plain version), a finite ATE where there is ground
           truth, finite disps_up, frames/s end to end, the time split, peak
           memory, and the EuRoC readers' ms a frame;
   multisession  the multisession commands and view through the CLI on the
           EuRoC sequence, stereo 320x512, in fp32 and then bf16 (see
           phase_multisession): session A with --vis_path, B = T_known * A,
           multisession-align (T_known recovered) with the joint backend,
           --improve behind a shut gate (rejected) and an open one
           (stitched), multisession --subsample 2, multisession-evaluate and
           view --color_by_session; per stage the counts are set to 0 and
           read (the probe's K2 and K3 in the compute dtype launch in
           --improve), each kernel held on the stage's inputs, seconds and
           peak memory; Droid.track frames/s of the cli's 40-frame euroc
           --stereo bf16 against the same command with --vis_path;
           the probe's bf16 summed confidence against fp32's on one state;
           joint_backend and fuse_maps at 64x96 on the card against the CPU;
6. profile-frontend  the frontend profiler (tools/profile_frontend.py) at
           bench.py's shape, E = 48 edges over a 24-frame window at 40x64,
           in fp32 and in bf16: every section on the card, with the counts
           set to 0 before and read after; every kernel of the dtype must
           launch (K6-K8 only here: none of them may launch on the main
           path) and no plain version run;
7. train   the training path (plain PyTorch under autograd, no kernel):
           (a) one dynamic step at 64x64 on the card against the CPU;
           (b) TrainConfig's full shape (384x512, 7 frames, 15 iterations,
           28 edges) in fp32 with and without remat and in bf16: seconds
           per step split into forward, backward and optimizer, peak
           memory, a profiled step (idle share, top kernels) and the
           training lookup's plain time; (c) an overfit whose loss falls;
           (d) cli train at the full crop, a resume, and tartanair with the
           trained weights; around (b)-(d) every count must stay 0
           (train.json in chiprun_out/ holds the numbers);
8. parallel  the parallel/ package and the JPEG reader on the one card
           (every shard on cuda:0): dist_ba_solve at 40x64, MW = 128, S = 2
           and 4, both exchanges, against the unsharded solve, K1 launched
           S x 2 a call and held on shard 0's inputs, each timed; on copies
           of the mono bf16 main path's tracked state, one backend step with
           refresh_shards 2 against 1 (bit for bit) and terminate_eva with
           ba_shards=2 and refresh_shards=2 against the main path's (its
           counts: K1, K2 bf16 -> fp32, K3, K4/K5 bf16, no plain version);
           training at world size 1 over NCCL (make_parallel_train_step and
           cli train, each bit for bit against one process); the eth3d
           command on color/*.jpg built from tests/data/jpeg/ (bf16,
           --depth), with the reader's ms a frame; every committed
           progressive and arithmetic-coded JPEG fixture decoded and held
           against its cv2 digest, ms a frame of each kind; the same eth3d
           command on the progressive frames of tests/data/jpeg_progressive/
           (parallel.json in chiprun_out/ holds the sharded BA's and the
           decoders' times).  The card-vs-CPU
           phase also runs mono 64x96 with ba_shards=2 and refresh_shards=2.
Then it prints the card's name and power limit, one JSON line describing
the kernels, and as its last line the device JSON.  The script needs only
torch, numpy and scipy, and the CUDA toolkit for nvcc.

    python3 chip_smoke.py --profile

adds a phase between tracking and terminate_eva, in each dtype: 12 more
keyframes, half of them timed per stage on the host clock and half under
torch.profiler, with the device kernel time and launches grouped (cuDNN's
layout transposes apart) and the device's idle share printed, and runs
terminate_eva under torch.profiler too; the full tables go to
chiprun_out/profile_main_path.txt and profile_terminate.txt (bf16:
profile_main_path_bf16.txt and profile_terminate_bf16.txt).
"""
import contextlib
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense TF32 and bf16 in the tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

# main-path shapes: EuRoC 320x512 -> 40x64 feature maps, 48 active edges
E_MAIN, H8, W8, C = 48, 40, 64, 128
INTR_EUROC = np.array([296.3, 290.1, 250.2, 168.1], np.float32)
N_MAIN = 40                    # frames of the main path (mono and stereo)
STEREO_SHIFT = 6               # px of disparity between the stereo main path's views
# the RGB-D main path: ETH3D_CONFIG (480x640), ETH3D's camera (726.28, 726.28,
# 354.65, 186.47 at 739x458) scaled to 640x480; 32 frames, 20 of them warmup
INTR_ETH3D = np.array([629.0, 761.2, 307.1, 195.4], np.float32)
N_RGBD = 32
N_BA, MW_BA = 64, 24           # 48 active + 16 inactive edges over a 24-frame window
K1_OPS_PER_PIXEL = 280         # flops per pixel, counted from csrc/ba_blocks.cu
# per edge: relative_pose (125 flops) in each of a cluster's 2 blocks, then
# L = -AdjT(Gij) formed and applied once: Hij = L Hjj, Hii = Hij L^T, vi = L vj
K1_OPS_PER_EDGE = 2 * 125 + 1220


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
        backend_steps_first=2, backend_steps_second=3,
    )


def euroc_frames(n, seed=0, H=320, W=512, step=4, shift=None):
    """Smoothed random texture panning `step` px per frame, 3-channel uint8.
    With `shift`, each frame is a stereo pair [2, H, W, 3]: the right view is
    the same texture cut `shift` px further along the pan (a disparity of
    `shift` px everywhere)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.RandomState(seed)
    base = gaussian_filter(rng.rand(H + 8, W + step * n + 8 + (shift or 0)), 2.0)
    base = (base - base.min()) / (base.max() - base.min()) * 255.0

    def view(t, dx):
        x0 = 4 + step * t + dx
        return np.repeat(base[4:4 + H, x0: x0 + W, None], 3, -1).astype(np.uint8)

    if shift is None:
        return [view(t, 0) for t in range(n)]
    return [np.stack([view(t, 0), view(t, shift)]) for t in range(n)]


def depth_frames(n, seed=0, H=480, W=640, step=4):
    """A smooth seeded depth map of 1 to 4 m panning with euroc_frames'
    texture, float32 [H, W] per frame (an RGB-D sensor's depth)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.RandomState(seed)
    base = gaussian_filter(rng.rand(H + 8, W + step * n + 8), 24.0)
    base = 1.0 + 3.0 * (base - base.min()) / (base.max() - base.min())
    return [base[4:4 + H, 4 + step * t: 4 + step * t + W].astype(np.float32) for t in range(n)]


def bound(ops, nbytes, tf32x3=0.0):
    """Least time in ms for `ops` fp32 operations outside the tensor cores,
    `tf32x3` fp32-accurate operations that a kernel takes as three TF32
    tensor-core products each (K2, K4, K8), and `nbytes` moved; and which of the
    two, operations or bytes, sets it."""
    t_ops = ops / PEAK_FP32 + 3.0 * tf32x3 / PEAK_TF32
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def ptxas_report(log, kernels):
    """Registers, spills and static shared memory of each `kernels` entry
    (substrings of the mangled name) in an `nvcc -Xptxas -v` log, with the
    template's pixel tile, for K8's instantiation of K4's template the word
    levels, and for a bf16 instantiation "bf16" (K2's with fp32 levels:
    "bf16 -> fp32")."""
    import re

    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = next((k for k in kernels if k in m.group(1)), None)
            args = re.search(r"ILi(\d+)E(?:Lb([01])E)?", m.group(1))
            if name and args:
                name += f"<{args.group(1)} pixels{', levels' if args.group(2) == '1' else ''}>"
            if name and "ILb1EfE" in m.group(1):        # K2 on bf16 features, fp32 levels
                name += " bf16 -> fp32"
            elif name and "__nv_bfloat16" in m.group(1):
                name += " bf16"
            bulk = re.search(r"windows_lookup_bf16_kernelILb([01])E", m.group(1))
            if name and bulk:                           # K5 bf16: how a span is read
                name += ", bulk copy" if bulk.group(1) == "1" else ", 2-byte loads"
            boxes = re.search(r"pmajor_lookup_bf16_kernelILb([01])E", m.group(1))
            if name and boxes:                          # K6 bf16: how its boxes are copied
                name += ", 16-byte copies" if boxes.group(1) == "1" else ", 2-byte copies"
        elif name and ("registers" in line or "spill" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def lookup_coords(torch, grid, E, gen):
    """The lookups' two kinds of coords around grid [1, P, 2]: "random", 2 px
    of noise with the first 64 pixels 50 px off the image, and "pan4", a
    smooth 4-px pan, the main path's motion."""
    rnd = (grid + torch.randn(E, grid.shape[1], 2, generator=gen, device=grid.device) * 2.0)
    rnd = rnd.contiguous()
    rnd[:, :64] += 50.0
    return {"random": rnd, "pan4": (grid + 4.0).expand(E, -1, 2).contiguous()}


def hold_lookups(torch, levels, padded, kinds, at):
    """K3 on K2's `levels` and, unless `padded` is None, K6 on the P-major
    levels of the same features, against their plain versions and K6
    against K3, for each kind of coords; tolerance 1e-5 * max(1, |ref|).
    Returns K3's output for the random coords and the largest error of K3
    and of K6."""
    from droid_slam_reserch_tpu_torch.ops import cuda_corr

    err3 = err6 = 0.0
    for kind, coords in kinds.items():
        out = cuda_corr.corr_lookup(levels, coords)
        ref = cuda_corr.corr_lookup_plain(levels, coords)
        torch.cuda.synchronize()
        tol = 1e-5 * max(1.0, float(ref.abs().max()))
        e3 = float((out - ref).abs().max())
        msg = f"K3 corr_lookup {at}, {kind} coords: max_abs_err {e3:.3e}"
        e6 = e63 = 0.0
        if padded is not None:
            out6 = cuda_corr.corr_lookup_pmajor(padded, coords)
            ref6 = cuda_corr.corr_lookup_pmajor_plain(padded, coords)
            torch.cuda.synchronize()
            e6 = float((out6 - ref6).abs().max())
            e63 = float((out6 - out).abs().max())
            msg += f"; K6 corr_lookup_pmajor {e6:.3e}, against K3 {e63:.3e}"
            del out6, ref6
        say("kernels", f"{msg} (tol {tol:.1e})")
        if not max(e3, e6, e63) <= tol:
            fail(f"K3 or K6 disagrees with its plain version, or K6 with K3, at {at} "
                 f"({kind} coords)")
        err3, err6 = max(err3, e3), max(err6, e6, e63)
        if kind == "random":
            first = out
        del ref
    return first, err3, err6


def grid_sample_inputs(torch, vols, coords, bases=None):
    """F.grid_sample's inputs for the radius-3 lookup: per level, the
    [E, P, h, w] volume (or the level's window, with bases) viewed as
    [E*P, 1, h, w] and the 7x7 grid around each pixel's coords, normalised
    for align_corners=True; output cell (a, b) is channel 7 a + b."""
    E, P = coords.shape[:2]
    taps = torch.arange(-3, 4, device=coords.device, dtype=torch.float32)
    out = []
    for l, v in enumerate(vols):
        h, w = v.shape[-2:]
        c = coords / 2 ** l
        x, y = c[..., 0], c[..., 1]
        if bases is not None:                    # window pixels: 8 - base
            y = y + 8 - bases[:, 2 * l].float()
            x = x + 8 - bases[:, 2 * l + 1].float()
        gx = (x[..., None, None] + taps[:, None]).expand(E, P, 7, 7)   # [.., a, b]
        gy = (y[..., None, None] + taps[None, :]).expand(E, P, 7, 7)
        grid = torch.stack([2 * gx / (w - 1) - 1, 2 * gy / (h - 1) - 1], -1)
        out.append((v.reshape(E * P, 1, h, w), grid.reshape(E * P, 7, 7, 2).contiguous()))
    return out


def window_grid_inputs(torch, levels, bases):
    """F.grid_sample's inputs for K7's function: per level, the [E, P, h, w]
    level viewed as [E*P, 1, h, w] and the level's WH x WW grid at the
    integer cells (base - 8 + row, base - 8 + column) of each pixel's
    window, normalised for align_corners=False (which, unlike True, also
    holds for a level one cell wide).  Sampled with mode="nearest" and zero
    padding, it cuts the windows with their zero border."""
    from droid_slam_reserch_tpu_torch.ops.corr import PPAD, win_shape

    E, _, P = bases.shape
    out = []
    for l, v in enumerate(levels):
        h, w = v.shape[-2:]
        WH, WW = win_shape(h, w)
        ys = ((bases[:, 2 * l] - PPAD).float()[..., None, None]
              + torch.arange(WH, device=v.device, dtype=torch.float32)[:, None])
        xs = ((bases[:, 2 * l + 1] - PPAD).float()[..., None, None]
              + torch.arange(WW, device=v.device, dtype=torch.float32)[None, :])
        ys, xs = torch.broadcast_tensors(ys, xs)
        grid = torch.stack([(2 * xs + 1) / w - 1, (2 * ys + 1) / h - 1], -1)
        out.append((v.reshape(E * P, 1, h, w), grid.reshape(E * P, WH, WW, 2).contiguous()))
    return out


def grid_sample_lookup(torch, inputs, mode="bilinear", align_corners=True):
    import torch.nn.functional as F

    return [F.grid_sample(v, g, mode=mode, padding_mode="zeros", align_corners=align_corners)
            for v, g in inputs]


def hold_windows(torch, f1, f2, levels, gen, tol2):
    """K4, K5 and K8 on (f1, f2) against their plain versions; K5(K4)
    against K3 on K2's `levels` where the drift rule holds; K8 against K2's
    levels and K4's windows within tol2, K2's tolerance.  Returns the
    first-round coords c0, the drifted coords c1, K4's windows and bases,
    K5's lookup and the largest error of each kernel."""
    from droid_slam_reserch_tpu_torch.geom import coords_grid
    from droid_slam_reserch_tpu_torch.ops import cuda_corr
    from droid_slam_reserch_tpu_torch.ops.corr import level_sizes, window_drift_ok

    dev = f1.device
    E, H1, W1 = f1.shape[:3]
    H2, W2 = f2.shape[1:3]
    P = H1 * W1
    at = f"E={E} {H2}x{W2}"
    grid = coords_grid(H1, W1, device=dev).reshape(1, P, 2)
    c0 = (grid + 2.0 * torch.randn(E, P, 2, generator=gen, device=dev)).contiguous()
    c0[:, :64] += 50.0                             # some windows at the level's edge
    wins, bases = cuda_corr.corr_build_windows(f1, f2, c0)
    pwins, pbases = cuda_corr.corr_build_windows_plain(f1, f2, c0)
    torch.cuda.synchronize()
    same_bases = bool((bases == pbases).all())
    err4 = float((wins - pwins).abs().max())
    tol4 = 1e-5 * max(1.0, float(pwins.abs().max()))
    say("kernels", f"K4 corr_build_windows {at}: bases equal {same_bases}, windows "
                   f"max_abs_err {err4:.3e} (tol {tol4:.1e})")
    if not (same_bases and err4 <= tol4):
        fail(f"K4 disagrees with its plain version at {at}")
    del pwins, pbases
    c1 = (c0 + 4.0 * torch.rand(E, P, 2, generator=gen, device=dev) - 2.0).contiguous()
    if not bool(window_drift_ok(bases, c1, level_sizes(H2, W2))):
        fail("a drift of at most 2 px left the cached windows")
    out5 = cuda_corr.corr_lookup_windows(wins, bases, c1, (H2, W2))
    ref5 = cuda_corr.corr_lookup_windows_plain(wins, bases, c1, (H2, W2))
    full = cuda_corr.corr_lookup(levels, c1)
    torch.cuda.synchronize()
    err5 = float((out5 - ref5).abs().max())
    tol5 = 1e-5 * max(1.0, float(ref5.abs().max()))
    err53 = float((out5 - full).abs().max())
    tol53 = 1e-5 * max(1.0, float(full.abs().max()))
    say("kernels", f"K5 corr_lookup_windows {at}: max_abs_err {err5:.3e} (tol {tol5:.1e}); "
                   f"K5(K4) against K3(K2) where the drift rule holds: {err53:.3e} "
                   f"(tol {tol53:.1e})")
    if not (err5 <= tol5 and err53 <= tol53):
        fail(f"K5 disagrees with its plain version or with K3 at {at}")
    del ref5, full

    l8, w8, b8 = cuda_corr.corr_build_windows_levels(f1, f2, c0)
    pl8, pw8, pb8 = cuda_corr.corr_build_windows_levels_plain(f1, f2, c0)
    torch.cuda.synchronize()
    err8 = max(float((w8 - pw8).abs().max()),
               max(float((a - b).abs().max()) for a, b in zip(l8, pl8)))
    err82 = max(float((a - b).abs().max()) for a, b in zip(l8, levels))
    err84 = float((w8 - wins).abs().max())
    same8 = bool((b8 == pb8).all()) and bool((b8 == bases).all())
    say("kernels", f"K8 corr_build_windows_levels {at}: bases equal to the plain "
                   f"version's and K4's {same8}; levels and windows max_abs_err {err8:.3e}; "
                   f"levels against K2's {err82:.3e}, windows against K4's {err84:.3e} "
                   f"(tol {tol2:.1e})")
    if not (same8 and err8 <= tol2 and err82 <= tol2 and err84 <= tol2):
        fail(f"K8 disagrees with its plain version, K2 or K4 at {at}")
    del l8, w8, b8, pl8, pw8, pb8
    errs = dict(err4=err4, err5=max(err5, err53), err8=max(err8, err82, err84))
    return c0, c1, wins, bases, out5, errs


def build_bound(f1, f2):
    """K2's least time: f1 and f2 read and the four levels written once,
    against the product to fp32 accuracy as three TF32 tensor-core products."""
    E, H1, W1, C = f1.shape
    H2, W2 = f2.shape[1:3]
    P, Q = H1 * W1, H2 * W2
    cells = sum((H2 >> l) * (W2 >> l) for l in range(4))
    return bound(0, (f1.numel() + f2.numel() + E * P * cells) * 4, tf32x3=2.0 * E * P * Q * C)


def hold_build(torch, f1, f2):
    """K2 on (f1, f2) against its plain version, tolerance
    tol2 = 1e-5 * max(1, |level0|); returns K2's levels and (error, tol2)."""
    from droid_slam_reserch_tpu_torch.ops import cuda_corr

    E, H2, W2 = f2.shape[:3]
    levels = cuda_corr.corr_build(f1, f2)
    plain = cuda_corr.corr_build_plain(f1, f2)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) if a.numel() else 0.0 for a, b in zip(levels, plain))
    scale = float(plain[0].abs().max())
    tol = 1e-5 * max(1.0, scale)
    say("kernels", f"K2 corr_build E={E} {H2}x{W2}: max_abs_err {err:.3e} (tol {tol:.1e}, "
                   f"|level0| max {scale:.2f})")
    if not err <= tol:
        fail(f"K2 disagrees with its plain version at E={E} {H2}x{W2}")
    return levels, (err, tol)


def k1_problem(torch, gen, N, MW, self_edges=0):
    """K1's inputs at N edges over an MW-frame window at the main path's
    40x64: poses panning along x, random disparities, targets near the grid,
    random weights; the last 4 edges are the engine's zero-weight padding
    (ii = jj = 0) and, with self_edges, that many stereo self-edges (ii = jj)
    lead the batch."""
    from droid_slam_reserch_tpu_torch.geom import coords_grid
    from droid_slam_reserch_tpu_torch.lie import se3_exp

    dev = torch.device("cuda")
    xi = torch.cat([0.05 * torch.arange(MW, device=dev)[:, None].expand(MW, 3),
                    0.01 * torch.randn(MW, 3, generator=gen, device=dev)], 1)
    poses = se3_exp(xi).contiguous()
    disps = (0.5 + torch.rand(MW, H8, W8, generator=gen, device=dev)).contiguous()
    intr = torch.tensor([296.3 / 8, 290.1 / 8, 250.2 / 8, 168.1 / 8], device=dev)
    ii = torch.randint(0, MW, (N,), generator=gen, device=dev)
    jj = (ii + torch.randint(1, 4, (N,), generator=gen, device=dev)) % MW
    if N > 4:
        ii[-4:] = 0
        jj[-4:] = 0                              # padding edges, as the engine pads
    jj[:self_edges] = ii[:self_edges]
    target = (coords_grid(H8, W8, device=dev)
              + 1.5 * torch.randn(N, H8, W8, 2, generator=gen, device=dev)).contiguous()
    weight = torch.rand(N, H8, W8, 2, generator=gen, device=dev)
    return (target, weight, poses, disps, intr, ii, jj)


def hold_k1(torch, args, what, exact=False):
    """K1 against its plain version on `args`, 2e-4 * max(1, |ref|) per
    output; returns the largest error.  exact: the plain version evaluated
    in fp64 is the reference, and the fp32 plain version's distance to it
    and the kernel's to the fp32 one are printed beside (the trajectory
    filler's motion-only rounds converge to residuals far below the
    coordinates they are taken from, where v's fp32 value moves with the
    order of rounding by about the tolerance, in the plain version as in
    the kernel)."""
    from droid_slam_reserch_tpu_torch.ops import cuda_ba

    out = cuda_ba.ba_system_blocks(*args)
    if exact:
        plain = cuda_ba.build_system_blocks(*args)
        ref = cuda_ba.system_blocks(*[x.double() if x.is_floating_point() else x for x in args])
    else:
        ref = cuda_ba.build_system_blocks(*args)
    torch.cuda.synchronize()
    err, worst, ok = 0.0, (0.0, ""), True
    for k in ref:
        d = float((out[k].to(ref[k].dtype) - ref[k]).abs().max())
        tol = 2e-4 * max(1.0, float(ref[k].abs().max()))
        err = max(err, d)
        worst = max(worst, (d / tol, k))
        ok &= d <= tol
    extra = ""
    if exact:
        extra = "; " + ", ".join(
            f"{k}: fp32 plain to fp64 {float((plain[k].double() - ref[k]).abs().max()):.2e}, "
            f"kernel to fp32 plain {float((out[k] - plain[k]).abs().max()):.2e}"
            for k in ("vi", "vj"))
    say("kernels", f"K1 ba_blocks {what}: max_abs_err {err:.3e} against the plain version"
                   f"{' in fp64' if exact else ''} (tol 2e-4*max(1,|ref|) per output; nearest "
                   f"its tol: {worst[1]} at {worst[0]:.2f} of it){extra}")
    if not ok:
        fail(f"K1 disagrees with its plain version ({what})")
    return err


def windows_build_info(build):
    """K4/K8's geometry at the main path's 40x64 (corr_windows_build_info):
    fp32 then bf16, each source pixels a block, dynamic shared memory bytes,
    and K4's and K8's resident blocks per SM."""
    info = (ctypes.c_int * 8)()
    build.library().corr_windows_build_info(H8, W8, info)
    return list(info)


def phase_kernels(torch):
    from droid_slam_reserch_tpu_torch.geom import coords_grid
    from droid_slam_reserch_tpu_torch.ops import build, cuda_ba, cuda_corr
    from droid_slam_reserch_tpu_torch.ops.corr import (build_pyramid_pmajor, level_sizes,
                                                       pack_offsets, win_shape)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # ---- what the redesigned kernels compiled to, and K4's occupancy
    for line in ptxas_report(build.BUILD_LOG["ptxas"],
                             ("corr_build_kernel", "corr_build_bf16_kernel", "ba_blocks_kernel",
                              "windows_build_kernel", "windows_lookup_kernel", "corr_lookup_kernel",
                              "windows_lookup_bf16_kernel", "corr_lookup_bf16_kernel",
                              "pmajor_lookup_kernel", "extract_windows_kernel",
                              "pmajor_lookup_bf16_kernel", "extract_windows_bf16_kernel")):
        if "bf16" not in line:
            say("kernels", f"ptxas: {line}")
    info2 = (ctypes.c_int * 2)()
    build.library().corr_build_info(info2)
    say("kernels", f"K2: {info2[0]} bytes of dynamic shared memory a block, {info2[1]} "
                   f"block(s) resident per SM")
    info = windows_build_info(build)
    say("kernels", f"K4/K8 at {H8}x{W8}: {info[0]} source pixels and {info[1]} bytes of "
                   f"dynamic shared memory a block, {info[2]} (K4) and {info[3]} (K8) blocks "
                   f"resident per SM")

    # ---- K2, then K4, K5 and K8, then K3 and K6, at a ragged shape, 240x352
    # images: level sizes 30x44, 15x22, 7x11 and 3x5 (K4's last 8-row band
    # holds 6 rows; levels 2 and 3 are narrower than their windows; P = 1320
    # is a multiple of no lookup tile); and at 480x640 images, whose 80-cell
    # rows K4 takes 32 pixels a block, in column chunks
    for Er, Hr, Wr in ((4, 30, 44), (2, 60, 80)):
        fr1, fr2 = randn(Er, Hr, Wr, C), randn(Er, Hr, Wr, C)
        lr, (_, tolr) = hold_build(torch, fr1, fr2)
        hold_windows(torch, fr1, fr2, lr, gen, tolr)
        padr, _ = build_pyramid_pmajor(fr1, fr2)
        gridr = coords_grid(Hr, Wr, device=dev).reshape(1, Hr * Wr, 2)
        hold_lookups(torch, lr, padr, lookup_coords(torch, gridr, Er, gen), f"E={Er} {Hr}x{Wr}")
        del fr1, fr2, lr, padr

    # ---- K2 on a map wider than K4 takes: 384x960 images, 48x120 cells
    fw1, fw2 = randn(2, 48, 120, C), randn(2, 48, 120, C)
    hold_build(torch, fw1, fw2)
    del fw1, fw2

    # ---- K2 and K3 at the backend's chunk of EB = 64 edges
    EB = 64
    fb1, fb2 = randn(EB, H8, W8, C), randn(EB, H8, W8, C)
    lb, _ = hold_build(torch, fb1, fb2)
    gridb = coords_grid(H8, W8, device=dev).reshape(1, H8 * W8, 2)
    hold_lookups(torch, lb, None, lookup_coords(torch, gridb, EB, gen), f"E={EB}")
    del lb
    msb = cuda_ms(torch, lambda: cuda_corr.corr_build(fb1, fb2), 10)
    ab, bb = fb1.reshape(EB, H8 * W8, C), fb2.reshape(EB, H8 * W8, C).transpose(1, 2)
    lib_msb = cuda_ms(torch, lambda: torch.bmm(ab, bb), 10)
    boundb = build_bound(fb1, fb2)
    say("kernels", f"E={EB}: K2 {msb:.4f} ms, the backend's call per chunk (torch.bmm volume "
                   f"{lib_msb:.4f}, bound {boundb[0]:.4f} by {boundb[1]}, 3xTF32)")
    rows["corr_build_eb64"] = dict(ms=msb, library_ms=lib_msb, bound_ms=boundb[0])
    del fb1, fb2, ab, bb

    # ---- K2 / K3 at E = 48 (frontend) and E = 1 (motion filter)
    P = Q = H8 * W8
    for E in (E_MAIN, 1):
        f1 = randn(E, H8, W8, C)
        f2 = randn(E, H8, W8, C)
        levels, (err2, tol2) = hold_build(torch, f1, f2)

        # ---- K3, and K6 in the zero-bordered P-major pyramid (3.7 GB at E = 48)
        grid = coords_grid(H8, W8, device=dev).reshape(1, P, 2)
        kinds = lookup_coords(torch, grid, E, gen)
        coords = kinds["random"]
        padded, _ = build_pyramid_pmajor(f1, f2)
        out, err3, err6 = hold_lookups(torch, levels, padded, kinds, f"E={E}")

        reps = 10 if E == E_MAIN else 50
        ms2 = cuda_ms(torch, lambda: cuda_corr.corr_build(f1, f2), reps)
        plain_ms2 = cuda_ms(torch, lambda: cuda_corr.corr_build_plain(f1, f2), max(reps // 5, 2))
        a, b = f1.reshape(E, P, C), f2.reshape(E, Q, C).transpose(1, 2)
        lib_ms2 = cuda_ms(torch, lambda: torch.bmm(a, b), reps)
        bound2 = build_bound(f1, f2)

        # K3 and K6 with each kind of coords, and the library yardstick beside
        # them: F.grid_sample, one call per level, the grid built outside the
        # timed region
        ms3, ms6, lib_ms3 = {}, {}, {}
        for kind, cc in kinds.items():
            ms3[kind] = cuda_ms(torch, lambda: cuda_corr.corr_lookup(levels, cc), 4 * reps)
            ms6[kind] = cuda_ms(torch, lambda: cuda_corr.corr_lookup_pmajor(padded, cc), 4 * reps)
            gs3 = grid_sample_inputs(torch, levels, cc)
            lib_ms3[kind] = cuda_ms(torch, lambda: grid_sample_lookup(torch, gs3), 4 * reps)
            del gs3
            say("kernels", f"E={E}, {kind} coords: K3 {ms3[kind]:.4f} ms, K6 {ms6[kind]:.4f} ms, "
                           f"F.grid_sample x4 {lib_ms3[kind]:.4f} ms")
        plain_ms3 = cuda_ms(torch, lambda: cuda_corr.corr_lookup_plain(levels, coords),
                            max(reps // 5, 2))
        plain_ms6 = cuda_ms(torch, lambda: cuda_corr.corr_lookup_pmajor_plain(padded, coords),
                            max(reps // 5, 2))
        # K6 reads the 64 cells of each span (no bounds checks) and the coords,
        # and writes 196 floats
        bound6 = bound(E * P * 4 * (7 * 8 * 3 + 49 * 3),
                       (E * P * 4 * 64 + coords.numel() + out.numel()) * 4)
        # the 32-byte sectors that the spans' rows (K6: cells) touch
        sectors6 = sector_bound(torch, pmajor_spans(torch, padded, coords),
                                (coords.numel() + out.numel()) * 4)
        sectors3 = sector_bound(torch, lookup_spans(torch, levels, coords),
                                (coords.numel() + out.numel()) * 4)
        del padded
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
        gs3 = grid_sample_inputs(torch, levels, coords)
        lib3 = torch.cat([o.reshape(E, P, 49) for o in grid_sample_lookup(torch, gs3)], -1)
        err3_lib = float((lib3 - out).abs().max())
        tol_lib = 1e-4 * max(1.0, float(out.abs().max()))
        del gs3, lib3
        say("kernels", f"E={E}: K2 {ms2:.4f} ms (plain {plain_ms2:.4f}, torch.bmm volume "
                       f"{lib_ms2:.4f}, bound {bound2[0]:.4f} by {bound2[1]}, 3xTF32); random "
                       f"coords: K3 "
                       f"{ms3['random']:.4f} ms (plain {plain_ms3:.4f}, F.grid_sample x4 "
                       f"{lib_ms3['random']:.4f}, bound {bound3[0]:.4f} by {bound3[1]}, sectors "
                       f"{sectors3:.4f}), K6 {ms6['random']:.4f} ms (plain {plain_ms6:.4f}, bound "
                       f"{bound6[0]:.4f} by {bound6[1]}, sectors {sectors6:.4f}); grid_sample "
                       f"against K3 {err3_lib:.3e} (tol {tol_lib:.1e}: its [-1, 1] grid rounds "
                       f"the positions)")
        if not err3_lib <= tol_lib:
            fail(f"F.grid_sample does not compute K3's function at E={E}")
        if E == E_MAIN:
            rows["corr_build"] = dict(max_abs_err=err2, ms=ms2, plain_ms=plain_ms2,
                                      library_ms=lib_ms2, bound_ms=bound2[0], bound_by=bound2[1],
                                      ops_route="tf32x3")
            for name, err, ms, plain_ms, bnd, sectors in (
                    ("corr_lookup", err3, ms3, plain_ms3, bound3, sectors3),
                    ("corr_lookup_pmajor", err6, ms6, plain_ms6, bound6, sectors6)):
                rows[name] = dict(max_abs_err=err, ms=ms["random"], plain_ms=plain_ms,
                                  library_ms=lib_ms3["random"], bound_ms=bnd[0], bound_by=bnd[1],
                                  sector_bound_ms=sectors, ms_pan4=ms["pan4"],
                                  library_ms_pan4=lib_ms3["pan4"])
        else:
            rows["corr_build_e1"] = dict(ms=ms2, plain_ms=plain_ms2, library_ms=lib_ms2,
                                         bound_ms=bound2[0])

        # ---- K4 / K5 / K8: the window cache around first-round coords, its
        # lookup, and the build that stores the levels too
        c0, c1, wins, bases, out5, errs = hold_windows(torch, f1, f2, levels, gen, tol2)
        tol4 = 1e-5 * max(1.0, float(wins.abs().max()))

        ms4 = cuda_ms(torch, lambda: cuda_corr.corr_build_windows(f1, f2, c0), reps)
        plain_ms4 = cuda_ms(torch, lambda: cuda_corr.corr_build_windows_plain(f1, f2, c0),
                            max(reps // 5, 2))
        pooled = sum(v.numel() for v in levels[1:])       # 4 operations per pooled cell
        # the product to fp32 accuracy as three TF32 tensor-core products
        bound4 = bound(4.0 * pooled,
                       (f1.numel() + f2.numel() + c0.numel() + wins.numel() + bases.numel()) * 4,
                       tf32x3=2.0 * E * P * Q * C)
        ms5 = cuda_ms(torch, lambda: cuda_corr.corr_lookup_windows(wins, bases, c1, (H8, W8)),
                      4 * reps)
        plain_ms5 = cuda_ms(torch, lambda: cuda_corr.corr_lookup_windows_plain(
            wins, bases, c1, (H8, W8)), max(reps // 5, 2))
        # reads the 8x8 block of each window it samples, the bases and coords
        bound5 = bound(E * P * 4 * (7 * 8 * 3 + 49 * 3),
                       (E * P * 4 * 64 + bases.numel() + c1.numel() + out5.numel()) * 4)
        sectors5 = sector_bound(torch, window_spans(torch, wins, bases, c1, (H8, W8)),
                                (bases.numel() + c1.numel() + out5.numel()) * 4)
        sizes = level_sizes(H8, W8)
        offs = pack_offsets(sizes)[0]
        win_views = [wins[:, :, o:o + win_shape(*hw)[0], :win_shape(*hw)[1]]
                     for o, hw in zip(offs, sizes)]
        gs5 = grid_sample_inputs(torch, win_views, c1, bases)
        lib5 = torch.cat([o.reshape(E, P, 49) for o in grid_sample_lookup(torch, gs5)], -1)
        lib_ms5 = cuda_ms(torch, lambda: grid_sample_lookup(torch, gs5), 4 * reps)
        err5_lib = float((lib5 - out5).abs().max())
        del gs5, lib5, win_views
        say("kernels", f"E={E}: K4 {ms4:.4f} ms (plain {plain_ms4:.4f}, torch.bmm volume "
                       f"{lib_ms2:.4f}, bound {bound4[0]:.4f} by {bound4[1]}, 3xTF32); K5 "
                       f"{ms5:.4f} ms (plain {plain_ms5:.4f}, F.grid_sample x4 over the windows "
                       f"{lib_ms5:.4f}, bound {bound5[0]:.4f} by {bound5[1]}, sectors "
                       f"{sectors5:.4f}); grid_sample against K5 {err5_lib:.3e} (tol "
                       f"{tol_lib:.1e})")
        if not err5_lib <= tol_lib:
            fail(f"F.grid_sample over the windows does not compute K5's function at E={E}")
        say("kernels", f"E={E}: one update_fused call of 6 rounds, correlation only: "
                       f"K4 + 6 x K5 = {ms4 + 6 * ms5:.4f} ms against K2 + 6 x K3 = "
                       f"{ms2 + 6 * ms3['random']:.4f} ms")
        if E == E_MAIN:
            rows["corr_build_windows"] = dict(max_abs_err=errs["err4"], ms=ms4,
                                              plain_ms=plain_ms4, library_ms=lib_ms2,
                                              bound_ms=bound4[0], bound_by=bound4[1],
                                              ops_route="tf32x3")
            rows["corr_lookup_windows"] = dict(max_abs_err=errs["err5"], ms=ms5,
                                               plain_ms=plain_ms5, library_ms=lib_ms5,
                                               bound_ms=bound5[0], bound_by=bound5[1],
                                               sector_bound_ms=sectors5)

        # ---- K7: K4's windows cut out of K2's levels around c0
        w7, b7 = cuda_corr.corr_extract_windows(levels, c0)
        pw7, pb7 = cuda_corr.corr_extract_windows_plain(levels, c0)
        torch.cuda.synchronize()
        err7 = float((w7 - pw7).abs().max())
        err74 = float((w7 - wins).abs().max())
        same7 = bool((b7 == pb7).all()) and bool((b7 == bases).all())
        say("kernels", f"K7 corr_extract_windows E={E}: bases equal to the plain version's and "
                       f"K4's {same7}, windows max_abs_err {err7:.3e}, against K4's {err74:.3e} "
                       f"(tol {tol4:.1e})")
        if not (same7 and err7 <= tol4 and err74 <= tol4):
            fail(f"K7 disagrees with its plain version or with K4 at E={E}")
        del pw7, pb7
        ms7 = cuda_ms(torch, lambda: cuda_corr.corr_extract_windows(levels, c0), reps)
        plain_ms7 = cuda_ms(torch, lambda: cuda_corr.corr_extract_windows_plain(levels, c0),
                            max(reps // 5, 2))
        # the window cells inside each level are read, every cell and base written
        need7 = window_cells_in_levels(torch, sizes, b7)
        bound7 = bound(0, (need7 + c0.numel() + w7.numel() + b7.numel()) * 4)
        sectors7 = sector_bound(torch, window_rows_in_levels(torch, levels, b7),
                                (c0.numel() + w7.numel() + b7.numel()) * 4)
        # the library yardstick: F.grid_sample nearest, one call per level, at
        # the integer grid of each window, built outside the timed region
        gs7 = window_grid_inputs(torch, levels, b7)
        lib7 = grid_sample_lookup(torch, gs7, "nearest", align_corners=False)
        err7_lib = max(float((o.reshape(E, P, *o.shape[-2:])
                              - w7[:, :, off:off + o.shape[-2], :o.shape[-1]]).abs().max())
                       for o, off in zip(lib7, offs))
        lib_ms7 = cuda_ms(torch, lambda: grid_sample_lookup(torch, gs7, "nearest",
                                                            align_corners=False), reps)
        del gs7, lib7
        say("kernels", f"E={E}: F.grid_sample nearest x4 against K7's windows {err7_lib:.3e} "
                       f"(tol 0: a copy of cells)")
        if not err7_lib == 0.0:
            fail(f"F.grid_sample nearest does not compute K7's function at E={E}")
        del w7, b7

        # ---- K8: K2's levels and K4's windows and bases in one pass (held above)
        l8, w8, b8 = cuda_corr.corr_build_windows_levels(f1, f2, c0)
        ms8 = cuda_ms(torch, lambda: cuda_corr.corr_build_windows_levels(f1, f2, c0), reps)
        plain_ms8 = cuda_ms(torch, lambda: cuda_corr.corr_build_windows_levels_plain(f1, f2, c0),
                            max(reps // 5, 2))
        bound8 = bound(4.0 * pooled,
                       (f1.numel() + f2.numel() + c0.numel() + w8.numel() + b8.numel()
                        + sum(v.numel() for v in l8)) * 4,
                       tf32x3=2.0 * E * P * Q * C)
        del l8, w8, b8
        say("kernels", f"E={E}: K7 {ms7:.4f} ms (plain {plain_ms7:.4f}, F.grid_sample nearest "
                       f"x4 {lib_ms7:.4f}, bound {bound7[0]:.4f} by {bound7[1]}, sectors "
                       f"{sectors7:.4f}); K8 {ms8:.4f} ms "
                       f"(plain {plain_ms8:.4f}, torch.bmm volume {lib_ms2:.4f}, bound "
                       f"{bound8[0]:.4f} by {bound8[1]}, 3xTF32)")
        if E == E_MAIN:
            rows["corr_extract_windows"] = dict(max_abs_err=max(err7, err74), ms=ms7,
                                                plain_ms=plain_ms7, library_ms=lib_ms7,
                                                bound_ms=bound7[0], bound_by=bound7[1],
                                                sector_bound_ms=sectors7)
            rows["corr_build_windows_levels"] = dict(max_abs_err=errs["err8"],
                                                     ms=ms8, plain_ms=plain_ms8,
                                                     library_ms=lib_ms2, bound_ms=bound8[0],
                                                     bound_by=bound8[1], ops_route="tf32x3")
        del levels, out, wins, bases, out5

    # ---- K1 at N = 64 edges over a 24-frame window, at 1 edge, and with
    # stereo self-edges (ii == jj), whose relative pose the kernel overrides
    args = k1_problem(torch, gen, N_BA, MW_BA)
    err1 = hold_k1(torch, args, f"N={N_BA} over {MW_BA} frames")
    err1 = max(err1, hold_k1(torch, k1_problem(torch, gen, 1, MW_BA), "N=1"))
    err1 = max(err1, hold_k1(torch, k1_problem(torch, gen, N_BA, MW_BA, self_edges=16),
                             f"N={N_BA} with 16 stereo self-edges"))
    out1 = cuda_ba.outputs(N_BA, H8, W8, dev)
    ms1 = cuda_ms(torch, lambda: cuda_ba.launch(out1, *args), 50)
    wrapper_ms1 = cuda_ms(torch, lambda: cuda_ba.ba_system_blocks(*args), 50)
    call_ms1 = cuda_ms(torch, lambda: cuda_ba.ba_system_blocks(*args), 50, device_only=False)
    plain_ms1 = cuda_ms(torch, lambda: cuda_ba.build_system_blocks(*args), 10)
    bound1 = k1_bound(N_BA, MW_BA)
    rows["ba_blocks"] = dict(max_abs_err=err1, ms=ms1, plain_ms=plain_ms1, library_ms=None,
                             bound_ms=bound1[0], bound_by=bound1[1], call_ms=wrapper_ms1,
                             host_ms=call_ms1)
    say("kernels", f"K1 {ms1:.4f} ms the launch alone, {wrapper_ms1:.4f} ms the call's device "
                   f"time, {call_ms1:.4f} ms per call on the host clock (plain {plain_ms1:.4f}, "
                   f"bound {bound1[0]:.4f} by {bound1[1]})")
    return rows


# One bf16 rounding step of a value v is at most 2**-7 |v| (8 significant
# bits): a tolerance of BF16 * M allows one step at the largest magnitude M.
BF16 = 2.0 ** -7


def bound_bf16(ops, nbytes, products=0.0):
    """Least time in ms for `ops` fp32 operations outside the tensor cores,
    `products` operations on the bf16 tensor cores, and `nbytes` moved; and
    which of the two, operations or bytes, sets it."""
    t_ops = ops / PEAK_FP32 + products / PEAK_BF16
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def hold_build_bf16(torch, f1, f2, out_dtype):
    """K2 on bf16 (f1, f2) with `out_dtype` levels against its plain version.
    Tolerance: fp32 levels 1e-5 * max(1, |level0|) (exact bf16 products,
    fp32 sums in another order); bf16 levels one rounding step of the
    largest level-0 magnitude, BF16 * |level0| (the two sums may round to
    neighbouring bf16 values, and a pooled cell inherits that).  Returns the
    levels and the error."""
    from droid_slam_reserch_tpu_torch.ops import cuda_corr

    E, H2, W2 = f2.shape[:3]
    levels = cuda_corr.corr_build(f1, f2, out_dtype)
    plain = cuda_corr.corr_build_plain(f1, f2, out_dtype)
    torch.cuda.synchronize()
    err = max(float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
              for a, b in zip(levels, plain))
    scale = float(plain[0].float().abs().max())
    tol = 1e-5 * max(1.0, scale) if out_dtype == torch.float32 else BF16 * scale
    what = "bf16 -> fp32" if out_dtype == torch.float32 else "bf16 -> bf16"
    say("kernels-bf16", f"K2 corr_build {what} E={E} {H2}x{W2}: max_abs_err {err:.3e} "
                        f"(tol {tol:.1e}, |level0| max {scale:.3f})")
    if not (err <= tol and all(v.dtype == out_dtype for v in levels)):
        fail(f"K2 {what} disagrees with its plain version at E={E} {H2}x{W2}")
    return levels, err


def hold_lookup_bf16(torch, levels, coords, at):
    """K3 on bf16 levels against its plain version: the same fp32 arithmetic
    rounded once, so the tolerance is one rounding step, BF16 * |ref|."""
    from droid_slam_reserch_tpu_torch.ops import cuda_corr

    out = cuda_corr.corr_lookup(levels, coords)
    ref = cuda_corr.corr_lookup_plain(levels, coords)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = BF16 * float(ref.float().abs().max())
    differ = int((out != ref).sum())
    say("kernels-bf16", f"K3 corr_lookup bf16 {at}: max_abs_err {err:.3e} (tol {tol:.1e}), "
                        f"{differ} cells differ")
    if not (err <= tol and out.dtype == torch.bfloat16):
        fail(f"K3 bf16 disagrees with its plain version at {at}")
    return out, err


def hold_windows_bf16(torch, f1, f2, levels, gen):
    """K4 and K5 on bf16 (f1, f2) against their plain versions (windows:
    BF16 * |wins|, as K2's levels; K5: one rounding step of its output),
    and K5(K4) against K3(K2) on K2's bf16 `levels` where the drift rule
    holds (2 * BF16 * |ref|: windows and levels are rounded from sums taken
    in other orders).  Returns c0, c1, windows, bases, K5's lookup and errors."""
    from droid_slam_reserch_tpu_torch.geom import coords_grid
    from droid_slam_reserch_tpu_torch.ops import cuda_corr
    from droid_slam_reserch_tpu_torch.ops.corr import level_sizes, window_drift_ok

    dev = f1.device
    E, H1, W1 = f1.shape[:3]
    H2, W2 = f2.shape[1:3]
    P = H1 * W1
    at = f"E={E} {H2}x{W2}"
    grid = coords_grid(H1, W1, device=dev).reshape(1, P, 2)
    c0 = (grid + 2.0 * torch.randn(E, P, 2, generator=gen, device=dev)).contiguous()
    c0[:, :64] += 50.0
    wins, bases = cuda_corr.corr_build_windows(f1, f2, c0)
    pwins, pbases = cuda_corr.corr_build_windows_plain(f1, f2, c0)
    torch.cuda.synchronize()
    same = bool((bases == pbases).all())
    err4 = float((wins.float() - pwins.float()).abs().max())
    tol4 = BF16 * float(pwins.float().abs().max())
    say("kernels-bf16", f"K4 corr_build_windows bf16 {at}: bases equal {same}, windows "
                        f"max_abs_err {err4:.3e} (tol {tol4:.1e})")
    if not (same and err4 <= tol4 and wins.dtype == torch.bfloat16):
        fail(f"K4 bf16 disagrees with its plain version at {at}")
    del pwins, pbases
    c1 = (c0 + 4.0 * torch.rand(E, P, 2, generator=gen, device=dev) - 2.0).contiguous()
    if not bool(window_drift_ok(bases, c1, level_sizes(H2, W2))):
        fail("a drift of at most 2 px left the cached windows")
    out5 = cuda_corr.corr_lookup_windows(wins, bases, c1, (H2, W2))
    ref5 = cuda_corr.corr_lookup_windows_plain(wins, bases, c1, (H2, W2))
    full = cuda_corr.corr_lookup(levels, c1)
    torch.cuda.synchronize()
    err5 = float((out5.float() - ref5.float()).abs().max())
    tol5 = BF16 * float(ref5.float().abs().max())
    err53 = float((out5.float() - full.float()).abs().max())
    tol53 = 2 * BF16 * float(full.float().abs().max())
    differ5 = int((out5 != ref5).sum())
    say("kernels-bf16", f"K5 corr_lookup_windows bf16 {at}: max_abs_err {err5:.3e} (tol "
                        f"{tol5:.1e}), {differ5} cells differ; K5(K4) against K3(K2) where the "
                        f"drift rule holds: {err53:.3e} (tol {tol53:.1e})")
    if not (err5 <= tol5 and err53 <= tol53 and out5.dtype == torch.bfloat16):
        fail(f"K5 bf16 disagrees with its plain version or with K3 at {at}")
    return c0, c1, wins, bases, out5, dict(err4=err4, err5=max(err5, err53))


def hold_pmajor_windows_bf16(torch, f1, f2, levels, c0, kinds, at):
    """K6, K7 and K8 on bf16 (f1, f2) against their plain versions: K6 on the
    bf16 P-major pyramid for each kind of coords and K7 on K2's bf16 `levels`
    around c0, exactly (the plain version's fp32 arithmetic rounded once, and
    a copy of cells); K8's levels and windows within one rounding step of the
    largest level-0 magnitude, BF16 * |level0| (as K2 bf16: the sums run in
    another order), its windows equal to K7 bf16 cut from K8's own levels,
    its bases to the plain version's.  Returns the P-major pyramid, K7's
    windows and bases, K8's outputs and the errors."""
    from droid_slam_reserch_tpu_torch.ops import cuda_corr
    from droid_slam_reserch_tpu_torch.ops.corr import build_pyramid_pmajor

    bf16 = torch.bfloat16
    padded, _ = build_pyramid_pmajor(f1, f2, dtype=bf16)
    err6, typed = 0.0, True
    for cc in kinds.values():
        out = cuda_corr.corr_lookup_pmajor(padded, cc)
        ref = cuda_corr.corr_lookup_pmajor_plain(padded, cc)
        torch.cuda.synchronize()
        err6 = max(err6, float((out.float() - ref.float()).abs().max()))
        typed &= out.dtype == bf16
    w7, b7 = cuda_corr.corr_extract_windows(levels, c0)
    pw7, pb7 = cuda_corr.corr_extract_windows_plain(levels, c0)
    torch.cuda.synchronize()
    err7 = float((w7.float() - pw7.float()).abs().max())
    same7 = bool((b7 == pb7).all())
    del pw7, pb7
    l8, w8, b8 = cuda_corr.corr_build_windows_levels(f1, f2, c0)
    pl8, pw8, pb8 = cuda_corr.corr_build_windows_levels_plain(f1, f2, c0)
    w78, b78 = cuda_corr.corr_extract_windows(l8, c0)
    torch.cuda.synchronize()
    err8 = max([float((a.float() - b.float()).abs().max()) for a, b in zip(l8, pl8) if a.numel()]
               + [float((w8.float() - pw8.float()).abs().max())])
    err87 = float((w8.float() - w78.float()).abs().max())
    same8 = bool((b8 == pb8).all()) and bool((b78 == b8).all())
    tol8 = BF16 * float(pl8[0].float().abs().max())
    typed &= w7.dtype == bf16 and w8.dtype == bf16 and all(v.dtype == bf16 for v in l8)
    del pl8, pw8, pb8, w78, b78
    say("kernels-bf16", f"{at}: K6 corr_lookup_pmajor_bf16 max_abs_err {err6:.3e} (tol 0, "
                        f"{len(kinds)} kinds of coords); K7 corr_extract_windows_bf16 bases equal "
                        f"{same7}, windows {err7:.3e} (tol 0); K8 corr_build_windows_levels_bf16 "
                        f"bases equal {same8}, levels and windows {err8:.3e} (tol {tol8:.1e}), "
                        f"windows against K7 bf16 over K8's levels {err87:.3e} (tol 0)")
    if not (typed and err6 == 0.0 and same7 and err7 == 0.0 and same8 and err8 <= tol8
            and err87 == 0.0):
        fail(f"K6, K7 or K8 in bf16 disagrees with its plain version, or K8 with K7, at {at}")
    return padded, (w7, b7), (l8, w8, b8), dict(err6=err6, err7=err7, err8=max(err8, err87))


def window_cells_in_levels(torch, sizes, bases):
    """The window cells that lie inside their level: what K7 must read."""
    from droid_slam_reserch_tpu_torch.ops.corr import win_shape

    need = 0
    for l, (h, w) in enumerate(sizes):
        WH, WW = win_shape(h, w)
        r0 = bases[:, 2 * l].long() - 8
        x0 = bases[:, 2 * l + 1].long() - 8
        rows_in = r0.add(WH).clamp_max(h) - r0.clamp_min(0)
        cols_in = x0.add(WW).clamp_max(w) - x0.clamp_min(0)
        need += int((rows_in.clamp_min(0) * cols_in.clamp_min(0)).sum())
    return need


def sector_bound(torch, spans, nbytes):
    """Least time in ms to move, at the HBM rate, every 32-byte sector that
    the byte ranges of `spans` touch, each once ((start, end) address
    tensors; every sector from a range's first to its last), and `nbytes`
    more."""
    sectors = 0
    for start, end in spans:
        first, last = start // 32, (end - 1) // 32
        touched = [first]
        for k in range(1, int((last - first).max()) + 1 if first.numel() else 0):
            touched.append((first + k)[first + k <= last])
        sectors += int(torch.unique(torch.cat(touched)).numel())
    return 1e3 * (32 * sectors + nbytes) / PEAK_BYTES


def _span_start(torch, c, l, radius=3):
    """floor(coords / 2^l) - radius, x and y, as int64 [E, P] (the kernels'
    clamped floor)."""
    c = c / 2 ** l
    f = torch.floor(c).clamp(-1e6, 1e6).long() - radius
    return f[..., 0], f[..., 1]


def lookup_spans(torch, levels, coords):
    """K3's reads: per level, the byte range of each 8-cell span row inside
    the level, clipped to it."""
    spans = []
    for l, v in enumerate(levels):
        E, P, h, w = v.shape
        x0, y0 = _span_start(torch, coords, l)
        rows = y0[..., None] + torch.arange(8, device=v.device)             # [E, P, 8]
        c0, c1 = x0.clamp(min=0)[..., None], (x0 + 8).clamp(max=w)[..., None]
        ok = (rows >= 0) & (rows < h) & (c1 > c0)
        base = (torch.arange(E * P, device=v.device).view(E, P, 1) * h + rows) * w
        es = v.element_size()
        spans.append((((base + c0) * es + v.data_ptr())[ok], ((base + c1) * es + v.data_ptr())[ok]))
    return spans


def window_rows_in_levels(torch, levels, bases):
    """K7's reads: per level, the byte range of each window row that lies
    inside the level, clipped to the level's columns."""
    from droid_slam_reserch_tpu_torch.ops.corr import PPAD, win_shape

    spans = []
    for l, v in enumerate(levels):
        E, P, h, w = v.shape
        WH, WW = win_shape(h, w)
        y0, x0 = bases[:, 2 * l].long() - PPAD, bases[:, 2 * l + 1].long() - PPAD
        rows = y0[..., None] + torch.arange(WH, device=v.device)            # [E, P, WH]
        c0, c1 = x0.clamp(min=0)[..., None], (x0 + WW).clamp(max=w)[..., None]
        ok = (rows >= 0) & (rows < h) & (c1 > c0)
        base = (torch.arange(E * P, device=v.device).view(E, P, 1) * h + rows) * w
        es = v.element_size()
        spans.append((((base + c0) * es + v.data_ptr())[ok], ((base + c1) * es + v.data_ptr())[ok]))
    return spans


def window_spans(torch, wins, bases, coords, hw):
    """K5's reads: the byte range of each 8-cell span row of each level's
    window."""
    from droid_slam_reserch_tpu_torch.ops.corr import PPAD, level_sizes, pack_offsets, win_shape

    E, P, sum_wh, ww = wins.shape
    sizes = level_sizes(*hw)
    starts = []
    for l, (off, (h, w)) in enumerate(zip(pack_offsets(sizes)[0], sizes)):
        WH, WW = win_shape(h, w)
        x0, y0 = _span_start(torch, coords, l)
        sy = (y0 + PPAD - bases[:, 2 * l].long()).clamp(0, WH - 8)
        sx = (x0 + PPAD - bases[:, 2 * l + 1].long()).clamp(0, WW - 8)
        rows = (torch.arange(E * P, device=wins.device).view(E, P, 1) * sum_wh + off
                + sy[..., None] + torch.arange(8, device=wins.device))
        starts.append((rows * ww + sx[..., None]).reshape(-1))
    start = torch.cat(starts) * wins.element_size() + wins.data_ptr()
    return [(start, start + 8 * wins.element_size())]


def pmajor_spans(torch, padded, coords):
    """K6's reads: per level, each of the 64 cells of each span in the
    pixels-last padded level [E, Hp, Wp, P]."""
    spans = []
    for l, v in enumerate(padded):
        E, Hp, Wp, P = v.shape
        x0, y0 = _span_start(torch, coords, l)
        taps = torch.arange(8, device=v.device)
        rows = (y0 + 8).clamp(0, Hp - 8)[..., None, None] + taps[:, None]
        cols = (x0 + 8).clamp(0, Wp - 8)[..., None, None] + taps
        e = torch.arange(E, device=v.device).view(E, 1, 1, 1)
        p = torch.arange(P, device=v.device).view(1, P, 1, 1)
        start = (((e * Hp + rows) * Wp + cols) * P + p).reshape(-1) * v.element_size()
        start = start + v.data_ptr()
        spans.append((start, start + v.element_size()))
    return spans


def phase_kernels_bf16(torch):
    """The bf16 instantiations of K2 (bf16 and fp32 levels), K3, K4, K5, K6,
    K7 and K8 against their plain bf16 versions, at the shapes of the bf16
    path (E = 48 and E = 1 at 40x64, K2 also at the backend's EB = 64, all
    also at the ragged 30x44, at 60x80, at the odd widths 30x45, 24x34 and
    24x66, and on the 48x120 map), and
    timed beside their plain versions and, as the library yardstick,
    torch.bmm of the bf16 volume (K2, K4, K8; K2 with fp32 levels beside
    torch.bmm from bf16 to an fp32 volume, out_dtype) and F.grid_sample on the bf16
    levels or windows (K3, K5, K6 bilinear; its grid is bf16 too, as the call
    requires, so its positions are rounded and its output is not held; K7
    nearest, whose rounded grid still picks each window's cells at 40x64, so
    it is held exactly)."""
    from droid_slam_reserch_tpu_torch.geom import coords_grid
    from droid_slam_reserch_tpu_torch.ops import build, cuda_corr
    from droid_slam_reserch_tpu_torch.ops.corr import level_sizes, pack_offsets, win_shape

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}

    def randn16(*shape):
        return (0.3 * torch.randn(*shape, generator=gen, device=dev)).to(bf16)

    for line in ptxas_report(build.BUILD_LOG["ptxas"],
                             ("corr_build_kernel", "corr_build_bf16_kernel",
                              "windows_build_bf16_kernel", "windows_lookup_kernel",
                              "corr_lookup_kernel", "windows_lookup_bf16_kernel",
                              "corr_lookup_bf16_kernel", "pmajor_lookup_kernel",
                              "extract_windows_kernel", "pmajor_lookup_bf16_kernel",
                              "extract_windows_bf16_kernel")):
        if "bf16" in line:
            say("kernels-bf16", f"ptxas: {line}")
    info = windows_build_info(build)[4:]
    say("kernels-bf16", f"K4/K8 bf16 at {H8}x{W8}: {info[0]} source pixels and {info[1]} bytes "
                        f"of dynamic shared memory a block, {info[2]} (K4) and {info[3]} (K8) "
                        f"blocks resident per SM")
    EB = 64
    for E in (E_MAIN, 1, EB):
        g = (ctypes.c_int * 6)()
        build.check(build.library().corr_build_bf16_info(E, H8 * W8, H8, W8, g),
                    "corr_build_bf16_info")
        say("kernels-bf16", f"K2 bf16 at E={E} {H8}x{W8}: {g[0]} persistent blocks over {g[1]} "
                            f"tiles, at most {g[2]} tiles a block, {g[3]} stages, {g[4]} bytes of "
                            f"dynamic shared memory a block, {g[5]} block(s) resident per SM")

    # ragged 30x44, 60x80 and the 48x120 map (K4's and K8's column chunks), odd
    # widths and levels whose rows are not 16-byte runs (45, 34, 66), an odd
    # P (27x45: the lookups' output runs of edge 1 start at odd pixels), EB = 64
    for Er, Hr, Wr in ((4, 30, 44), (2, 60, 80), (2, 48, 120), (2, 30, 45), (2, 24, 34),
                       (2, 24, 66), (2, 27, 45)):
        fr1, fr2 = randn16(Er, Hr, Wr, C), randn16(Er, Hr, Wr, C)
        hold_build_bf16(torch, fr1, fr2, f32)
        lr, _ = hold_build_bf16(torch, fr1, fr2, bf16)
        gridr = coords_grid(Hr, Wr, device=dev).reshape(1, Hr * Wr, 2)
        kindsr = lookup_coords(torch, gridr, Er, gen)
        for kind, cc in kindsr.items():
            hold_lookup_bf16(torch, lr, cc, f"E={Er} {Hr}x{Wr}, {kind} coords")
        c0r = hold_windows_bf16(torch, fr1, fr2, lr, gen)[0]
        hold_pmajor_windows_bf16(torch, fr1, fr2, lr, c0r, kindsr, f"E={Er} {Hr}x{Wr}")
        del fr1, fr2, lr
    fb1, fb2 = randn16(EB, H8, W8, C), randn16(EB, H8, W8, C)
    hold_build_bf16(torch, fb1, fb2, bf16)
    _, errb = hold_build_bf16(torch, fb1, fb2, f32)
    msb = cuda_ms(torch, lambda: cuda_corr.corr_build(fb1, fb2, f32), 10)
    plain_msb = cuda_ms(torch, lambda: cuda_corr.corr_build_plain(fb1, fb2, f32), 2)
    ab, bb = fb1.reshape(EB, H8 * W8, C), fb2.reshape(EB, H8 * W8, C).transpose(1, 2)
    # the library yardsticks: the volume in bf16, and from bf16 to fp32 as
    # these levels are
    lib_msb16 = cuda_ms(torch, lambda: torch.bmm(ab, bb), 10)
    lib_msb = cuda_ms(torch, lambda: torch.bmm(ab, bb, out_dtype=f32), 10)
    del fb1, fb2, ab, bb

    P = Q = H8 * W8
    cells = sum((H8 >> l) * (W8 >> l) for l in range(4))
    for E in (E_MAIN, 1):
        f1, f2 = randn16(E, H8, W8, C), randn16(E, H8, W8, C)
        reps = 10 if E == E_MAIN else 50
        product = 2.0 * E * P * Q * C
        a, b = f1.reshape(E, P, C), f2.reshape(E, Q, C).transpose(1, 2)
        lib_ms2 = cuda_ms(torch, lambda: torch.bmm(a, b), reps)
        lib_ms2f = cuda_ms(torch, lambda: torch.bmm(a, b, out_dtype=f32), reps)
        for out_dtype, name in ((bf16, "corr_build_bf16"), (f32, "corr_build_bf16_f32")):
            levels, err2 = hold_build_bf16(torch, f1, f2, out_dtype)
            ms2 = cuda_ms(torch, lambda: cuda_corr.corr_build(f1, f2, out_dtype), reps)
            plain_ms2 = cuda_ms(torch, lambda: cuda_corr.corr_build_plain(f1, f2, out_dtype),
                                max(reps // 5, 2))
            bound2 = bound_bf16(0, (f1.numel() + f2.numel()) * 2
                                + E * P * cells * levels[0].element_size(), product)
            lib = lib_ms2 if out_dtype == bf16 else lib_ms2f
            say("kernels-bf16", f"E={E}: K2 {name} {ms2:.4f} ms (plain {plain_ms2:.4f}, "
                                f"torch.bmm {'bf16' if out_dtype == bf16 else 'bf16 -> fp32'} "
                                f"volume {lib:.4f}, bound {bound2[0]:.4f} by {bound2[1]})")
            row = dict(max_abs_err=err2, ms=ms2, plain_ms=plain_ms2, library_ms=lib,
                       bound_ms=bound2[0], bound_by=bound2[1], ops_route="bf16")
            if E == E_MAIN:
                rows[name] = row
            else:
                rows[name + "_e1"] = row
        del levels

        # K3 over bf16 levels
        levels, _ = hold_build_bf16(torch, f1, f2, bf16)
        grid = coords_grid(H8, W8, device=dev).reshape(1, P, 2)
        kinds = lookup_coords(torch, grid, E, gen)
        err3 = max(hold_lookup_bf16(torch, levels, cc, f"E={E}, {kind} coords")[1]
                   for kind, cc in kinds.items())
        coords = kinds["random"]
        ms3 = {k: cuda_ms(torch, lambda: cuda_corr.corr_lookup(levels, cc), 4 * reps)
               for k, cc in kinds.items()}
        plain_ms3 = cuda_ms(torch, lambda: cuda_corr.corr_lookup_plain(levels, coords),
                            max(reps // 5, 2))
        lib_ms3 = {}
        for kind, cc in kinds.items():
            gs = [(v, g.to(bf16)) for v, g in grid_sample_inputs(torch, levels, cc)]
            lib_ms3[kind] = cuda_ms(torch, lambda: grid_sample_lookup(torch, gs), 4 * reps)
            del gs
        need = 0
        off = torch.arange(-3, 5, device=dev)
        for l, v in enumerate(levels):
            h, w = v.shape[-2:]
            c = coords / 2 ** l
            ys = torch.floor(c[..., 1:2]).long() + off
            xs = torch.floor(c[..., 0:1]).long() + off
            need += int((((ys >= 0) & (ys < h)).sum(-1) * ((xs >= 0) & (xs < w)).sum(-1)).sum())
        bound3 = bound_bf16(E * P * 4 * (7 * 8 * 3 + 49 * 3),
                            need * 2 + coords.numel() * 4 + E * P * 196 * 2)
        sectors3 = sector_bound(torch, lookup_spans(torch, levels, coords),
                                coords.numel() * 4 + E * P * 196 * 2)
        say("kernels-bf16", f"E={E}: K3 corr_lookup_bf16 random coords {ms3['random']:.4f} ms, "
                            f"pan4 {ms3['pan4']:.4f} ms (plain {plain_ms3:.4f}, F.grid_sample "
                            f"x4 bf16 {lib_ms3['random']:.4f} / {lib_ms3['pan4']:.4f}, bound "
                            f"{bound3[0]:.4f} by {bound3[1]}, sectors {sectors3:.4f})")
        if E == E_MAIN:
            rows["corr_lookup_bf16"] = dict(max_abs_err=err3, ms=ms3["random"],
                                            plain_ms=plain_ms3, library_ms=lib_ms3["random"],
                                            bound_ms=bound3[0], bound_by=bound3[1],
                                            sector_bound_ms=sectors3, ms_pan4=ms3["pan4"],
                                            library_ms_pan4=lib_ms3["pan4"])

        # K4 and K5
        c0, c1, wins, bases, out5, errs = hold_windows_bf16(torch, f1, f2, levels, gen)
        ms4 = cuda_ms(torch, lambda: cuda_corr.corr_build_windows(f1, f2, c0), reps)
        plain_ms4 = cuda_ms(torch, lambda: cuda_corr.corr_build_windows_plain(f1, f2, c0),
                            max(reps // 5, 2))
        pooled = sum(v.numel() for v in levels[1:])
        bound4 = bound_bf16(4.0 * pooled, (f1.numel() + f2.numel() + wins.numel()) * 2
                            + (c0.numel() + bases.numel()) * 4, product)
        ms5 = cuda_ms(torch, lambda: cuda_corr.corr_lookup_windows(wins, bases, c1, (H8, W8)),
                      4 * reps)
        plain_ms5 = cuda_ms(torch, lambda: cuda_corr.corr_lookup_windows_plain(
            wins, bases, c1, (H8, W8)), max(reps // 5, 2))
        bound5 = bound_bf16(E * P * 4 * (7 * 8 * 3 + 49 * 3),
                            E * P * 4 * 64 * 2 + (bases.numel() + c1.numel()) * 4
                            + out5.numel() * 2)
        sectors5 = sector_bound(torch, window_spans(torch, wins, bases, c1, (H8, W8)),
                                (bases.numel() + c1.numel()) * 4 + out5.numel() * 2)
        sizes = level_sizes(H8, W8)
        offs = pack_offsets(sizes)[0]
        views = [wins[:, :, o:o + win_shape(*hw)[0], :win_shape(*hw)[1]]
                 for o, hw in zip(offs, sizes)]
        gs5 = [(v, g.to(bf16)) for v, g in grid_sample_inputs(torch, views, c1, bases)]
        lib_ms5 = cuda_ms(torch, lambda: grid_sample_lookup(torch, gs5), 4 * reps)
        del gs5, views
        say("kernels-bf16", f"E={E}: K4 corr_build_windows_bf16 {ms4:.4f} ms (plain "
                            f"{plain_ms4:.4f}, torch.bmm bf16 volume {lib_ms2:.4f}, bound "
                            f"{bound4[0]:.4f} by {bound4[1]}); K5 corr_lookup_windows_bf16 "
                            f"{ms5:.4f} ms (plain {plain_ms5:.4f}, F.grid_sample x4 bf16 over "
                            f"the windows {lib_ms5:.4f}, bound {bound5[0]:.4f} by {bound5[1]}, "
                            f"sectors {sectors5:.4f}); "
                            f"one update_fused call of 6 rounds, correlation only: K4 + 6 x K5 "
                            f"= {ms4 + 6 * ms5:.4f} ms")
        if E == E_MAIN:
            rows["corr_build_windows_bf16"] = dict(max_abs_err=errs["err4"], ms=ms4,
                                                   plain_ms=plain_ms4, library_ms=lib_ms2,
                                                   bound_ms=bound4[0], bound_by=bound4[1],
                                                   ops_route="bf16")
            rows["corr_lookup_windows_bf16"] = dict(max_abs_err=errs["err5"], ms=ms5,
                                                    plain_ms=plain_ms5, library_ms=lib_ms5,
                                                    bound_ms=bound5[0], bound_by=bound5[1],
                                                    sector_bound_ms=sectors5)
        del wins, bases, out5

        # K6 over the bf16 P-major pyramid, K7 over K2's bf16 levels, K8
        padded, (w7, b7), (l8, w8, b8), errs = hold_pmajor_windows_bf16(
            torch, f1, f2, levels, c0, kinds, f"E={E} {H8}x{W8}")
        ms6 = {k: cuda_ms(torch, lambda: cuda_corr.corr_lookup_pmajor(padded, cc), 4 * reps)
               for k, cc in kinds.items()}
        plain_ms6 = cuda_ms(torch, lambda: cuda_corr.corr_lookup_pmajor_plain(padded, coords),
                            max(reps // 5, 2))
        # the 64 cells of each span (no bounds checks), the coords, 196 outputs
        bound6 = bound_bf16(E * P * 4 * (7 * 8 * 3 + 49 * 3),
                            E * P * 4 * 64 * 2 + coords.numel() * 4 + E * P * 196 * 2)
        sectors6 = sector_bound(torch, pmajor_spans(torch, padded, coords),
                                coords.numel() * 4 + E * P * 196 * 2)
        del padded
        ms7 = cuda_ms(torch, lambda: cuda_corr.corr_extract_windows(levels, c0), reps)
        plain_ms7 = cuda_ms(torch, lambda: cuda_corr.corr_extract_windows_plain(levels, c0),
                            max(reps // 5, 2))
        bound7 = bound_bf16(0, window_cells_in_levels(torch, sizes, b7) * 2 + c0.numel() * 4
                            + w7.numel() * 2 + b7.numel() * 4)
        sectors7 = sector_bound(torch, window_rows_in_levels(torch, levels, b7),
                                c0.numel() * 4 + w7.numel() * 2 + b7.numel() * 4)
        gs7 = [(v, g.to(bf16)) for v, g in window_grid_inputs(torch, levels, b7)]
        lib7 = grid_sample_lookup(torch, gs7, "nearest", align_corners=False)
        err7_lib = max(float((o.reshape(E, P, *o.shape[-2:]).float()
                              - w7[:, :, off:off + o.shape[-2], :o.shape[-1]].float())
                             .abs().max()) for o, off in zip(lib7, offs))
        lib_ms7 = cuda_ms(torch, lambda: grid_sample_lookup(torch, gs7, "nearest",
                                                            align_corners=False), reps)
        del gs7, lib7
        if not err7_lib == 0.0:
            fail(f"F.grid_sample nearest in bf16 does not compute K7's function at E={E} "
                 f"({err7_lib:.3e})")
        ms8 = cuda_ms(torch, lambda: cuda_corr.corr_build_windows_levels(f1, f2, c0), reps)
        plain_ms8 = cuda_ms(torch, lambda: cuda_corr.corr_build_windows_levels_plain(f1, f2, c0),
                            max(reps // 5, 2))
        bound8 = bound_bf16(4.0 * pooled, (f1.numel() + f2.numel() + w8.numel()
                                           + sum(v.numel() for v in l8)) * 2
                            + (c0.numel() + b8.numel()) * 4, product)
        say("kernels-bf16", f"E={E}: K6 corr_lookup_pmajor_bf16 random coords "
                            f"{ms6['random']:.4f} ms, pan4 {ms6['pan4']:.4f} ms (plain "
                            f"{plain_ms6:.4f}, F.grid_sample x4 bf16 {lib_ms3['random']:.4f} / "
                            f"{lib_ms3['pan4']:.4f}, bound {bound6[0]:.4f} by {bound6[1]}, "
                            f"sectors {sectors6:.4f}); K7 "
                            f"corr_extract_windows_bf16 {ms7:.4f} ms (plain {plain_ms7:.4f}, "
                            f"F.grid_sample nearest x4 bf16 {lib_ms7:.4f}, against K7 "
                            f"{err7_lib:.3e}, bound {bound7[0]:.4f} by {bound7[1]}, sectors "
                            f"{sectors7:.4f}); K8 "
                            f"corr_build_windows_levels_bf16 {ms8:.4f} ms (plain {plain_ms8:.4f}, "
                            f"torch.bmm bf16 volume {lib_ms2:.4f}, bound {bound8[0]:.4f} by "
                            f"{bound8[1]})")
        new = {"corr_lookup_pmajor_bf16": dict(max_abs_err=errs["err6"], ms=ms6["random"],
                                               plain_ms=plain_ms6, library_ms=lib_ms3["random"],
                                               bound_ms=bound6[0], bound_by=bound6[1],
                                               sector_bound_ms=sectors6, ms_pan4=ms6["pan4"],
                                               library_ms_pan4=lib_ms3["pan4"]),
               "corr_extract_windows_bf16": dict(max_abs_err=errs["err7"], ms=ms7,
                                                 plain_ms=plain_ms7, library_ms=lib_ms7,
                                                 bound_ms=bound7[0], bound_by=bound7[1],
                                                 sector_bound_ms=sectors7),
               "corr_build_windows_levels_bf16": dict(max_abs_err=errs["err8"], ms=ms8,
                                                      plain_ms=plain_ms8, library_ms=lib_ms2,
                                                      bound_ms=bound8[0], bound_by=bound8[1],
                                                      ops_route="bf16")}
        for name, row in new.items():
            rows[name if E == E_MAIN else name + "_e1"] = row
        del levels, w7, b7, l8, w8, b8, f1, f2, a, b
    bound_b = bound_bf16(0, EB * P * 2 * C * 2 + EB * P * cells * 4, 2.0 * EB * P * Q * C)
    say("kernels-bf16", f"E={EB}: K2 corr_build_bf16_f32 {msb:.4f} ms, the backend's call per "
                        f"chunk (plain {plain_msb:.4f}, torch.bmm bf16 -> fp32 volume "
                        f"{lib_msb:.4f}, bf16 volume {lib_msb16:.4f}, bound {bound_b[0]:.4f} by "
                        f"{bound_b[1]})")
    rows["corr_build_bf16_f32_eb64"] = dict(max_abs_err=errb, ms=msb, plain_ms=plain_msb,
                                            library_ms=lib_msb, bound_ms=bound_b[0],
                                            bound_by=bound_b[1])
    return rows


def k1_bound(N, MW):
    """K1's least time at N edges over MW frames at 40x64: reads target,
    weight, disps, poses, ii/jj (int64) and the intrinsics once; writes H,
    v, E, C and w once."""
    HW = H8 * W8
    return bound(N * HW * K1_OPS_PER_PIXEL + N * K1_OPS_PER_EDGE,
                 (N * HW * 4 + MW * HW + MW * 7 + 4 * N + 4
                  + N * (144 + 12) + N * 12 * HW + N * HW * 2) * 4)


def phase_k1_backend(torch, n_edges, MW, self_edges=0):
    """K1 at the backend's largest graph of the main path (n_edges padded to
    the engine's edge bucket, over MW frames, with `self_edges` stereo
    self-edges), against its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    hold_k1(torch, k1_problem(torch, gen, n_edges, MW, self_edges=self_edges),
            f"N={n_edges} over {MW} frames with {self_edges} self-edges, the main path's "
            f"largest backend graph")


def phase_drift(torch, ops, dtype="float32"):
    """The frontend's per-call correlation (engine.factor_graph.WindowedLookup)
    at the main path's shapes, in the compute dtype: a small drift reads the
    windows (K5), drifts past the windows take the full lookup (K2 built
    once, K3 each time), and every answer equals the plain full lookup (fp32:
    within 1e-5; bf16: within two rounding steps, 2 * BF16, of the largest
    magnitude, since windows and levels are rounded from sums taken in other
    orders).  Returns the kernel counts of the run."""
    from droid_slam_reserch_tpu_torch.engine import factor_graph as fg
    from droid_slam_reserch_tpu_torch.geom import coords_grid
    from droid_slam_reserch_tpu_torch.ops import cuda_corr

    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    sfx = "" if dt == torch.float32 else "_bf16"
    gen = torch.Generator(device=dev).manual_seed(1)
    E, P = E_MAIN, H8 * W8
    f1 = torch.randn(E, H8, W8, C, generator=gen, device=dev).to(dt)
    f2 = torch.randn(E, H8, W8, C, generator=gen, device=dev).to(dt)
    c0 = (coords_grid(H8, W8, device=dev).reshape(1, P, 2)
          + torch.randn(E, P, 2, generator=gen, device=dev)).contiguous()
    ops.reset_counts()
    fg.reset_corr_rounds()
    lookup = fg.WindowedLookup(f1, f2, c0)
    drifts = (1.0, 12.0, -12.0)
    outs = [lookup((c0 + d).contiguous()) for d in drifts]
    torch.cuda.synchronize()
    counts, rounds = ops.counts(), fg.corr_rounds()
    levels = cuda_corr.corr_build_plain(f1, f2)
    err = 0.0
    for d, out in zip(drifts, outs):
        ref = cuda_corr.corr_lookup_plain(levels, (c0 + d).contiguous()).float()
        err = max(err, float((out.float() - ref).abs().max()) / max(1.0, float(ref.abs().max())))
    tol = 1e-5 if dt == torch.float32 else 2 * BF16
    say("drift", f"{dtype} E={E}: drifts {drifts} px -> rounds {rounds}; launches K4 "
                 f"{counts['corr_build_windows' + sfx][0]}, K5 "
                 f"{counts['corr_lookup_windows' + sfx][0]}, K2 {counts['corr_build' + sfx][0]}, "
                 f"K3 {counts['corr_lookup' + sfx][0]}; max error against the plain full lookup "
                 f"{err:.3e} relative (tol {tol:.1e})")
    want = {"corr_build_windows" + sfx: 1, "corr_lookup_windows" + sfx: 1, "corr_build" + sfx: 1,
            "corr_lookup" + sfx: 2}
    if rounds != {"windowed": 1, "fallback": 2} or any(counts[k][0] != n for k, n in want.items()):
        fail(f"the drift fallback was not taken as the rule says ({dtype})")
    if any(p for _, p in counts.values()) or any(
            n for k, (n, _) in counts.items() if k not in want):
        fail(f"the drift phase ran another kernel or a plain version: {counts}")
    if not all(o.dtype == dt for o in outs) or not err <= tol:
        fail(f"the windowed lookup or its fallback is not exact ({dtype})")
    return counts


FRONTEND_KERNELS = ("ba_blocks", "corr_build_windows", "corr_lookup_windows")
BACKEND_KERNELS = ("ba_blocks", "corr_build", "corr_lookup")
# the engine's; K6-K8 are on no engine path
MAIN_KERNELS = tuple(dict.fromkeys(FRONTEND_KERNELS + BACKEND_KERNELS))
# the engine's in bf16: K4/K5 in bf16 (frontend, filler), K2 on bf16 features
# with fp32 levels and the fp32 K3 (motion filter, backend), K1
FRONTEND_KERNELS_BF16 = ("ba_blocks", "corr_build_windows_bf16", "corr_lookup_windows_bf16")
BACKEND_KERNELS_BF16 = ("ba_blocks", "corr_build_bf16_f32", "corr_lookup")
MAIN_KERNELS_BF16 = tuple(dict.fromkeys(FRONTEND_KERNELS_BF16 + BACKEND_KERNELS_BF16))
# K6-K8 in both dtypes: on no engine path, so never launched on the main path
OFF_ENGINE = tuple(k + sfx for k in ("corr_lookup_pmajor", "corr_extract_windows",
                                     "corr_build_windows_levels") for sfx in ("", "_bf16"))


N_SMALL = 10       # frames of the 64x96 card-vs-CPU runs: 5 of warmup, then 5 updates


def small_frames(mode, n=N_SMALL):
    """The 64x96 card-vs-CPU frames: tests/test_engine.py's sequences, as
    (image, depth) pairs; stereo pairs the frame with itself rolled 2 px,
    RGB-D draws a depth of 2 to 2.5 before each frame."""
    rng = np.random.RandomState({"mono": 0, "upsample": 0, "sharded": 0, "stereo": 1,
                                 "rgbd": 2}[mode])
    out = []
    for t in range(n):
        depth = (2.0 + 0.5 * rng.rand(64, 96).astype(np.float32)) if mode == "rgbd" else None
        img = synth_small(t, rng)
        out.append((np.stack([img, np.roll(img, -2, axis=1)]) if mode == "stereo" else img, depth))
    return out


def phase_card_vs_cpu(torch, ops, dtype="float32", modes=("mono",)):
    """The oracle frontend and backend gates on the card, and the port's
    Droid.track + terminate_eva at 64x96 on the card against the same run on
    the CPU, in the compute dtype, for each sensor mode of `modes` (mono,
    stereo, rgbd, upsample: mono with cfg.upsample, whose disps_up after
    terminate_eva is compared too, and sharded: mono with ba_shards=2 and
    refresh_shards=2, whose counts on the card are returned; else None).
    Tolerance on poses, the trajectory and disps_up: fp32 1e-3; bf16 2e-2: bf16 keeps 8 significant bits, and the card's
    cuDNN and the CPU's convolutions round at other places (as the JAX
    package and the port do on the CPU, where 8 frames differ by 2.6e-3 in
    poses, tests/test_torch_bf16_engine.py), which terminate_eva's backend
    and filler compound."""
    from droid_slam_reserch_tpu_torch.engine import Droid
    from droid_slam_reserch_tpu_torch.eval import oracle
    from droid_slam_reserch_tpu_torch.eval.metrics import ate_rmse
    from droid_slam_reserch_tpu_torch.models import init_params
    from droid_slam_reserch_tpu_torch.utils import DroidConfig

    bf16 = dtype == "bfloat16"
    front_k, back_k = ((FRONTEND_KERNELS_BF16, ("ba_blocks", "corr_build_bf16_f32", "corr_lookup"))
                       if bf16 else (FRONTEND_KERNELS, BACKEND_KERNELS))
    ops.reset_counts()
    gt = oracle.gt_scene()
    v, front = oracle.drive_frontend(gt, device="cuda", compute_dtype=dtype)
    torch.cuda.synchronize()
    counts = ops.counts()
    err, _ = ate_rmse(oracle.cam_centers(v.poses[:oracle.T]), oracle.cam_centers(gt[0]),
                      align=True, correct_scale=True)
    say("card-vs-cpu", f"{dtype} oracle frontend gate on the card: ATE {err:.3e} (limit 1e-2), "
                       f"keyframes {v.counter}, launches {counts}")
    if not (err < 0.01 and v.counter == oracle.T):
        fail("oracle frontend gate on the card")
    if (any(counts[k][0] == 0 for k in front_k)
            or any(p != 0 for _, p in counts.values())):
        fail(f"oracle gate did not run through every kernel of the frontend: {counts}")

    ops.reset_counts()
    graph = oracle.drive_backend(v, gt, steps=2, itrs=2)
    torch.cuda.synchronize()
    counts = ops.counts()
    err, _ = ate_rmse(oracle.cam_centers(v.poses[:oracle.T]), oracle.cam_centers(gt[0]),
                      align=True, correct_scale=True)
    say("card-vs-cpu", f"{dtype} oracle backend gate on the card (2 update_lowmem steps over "
                       f"{len(graph.ii)} edges): ATE {err:.3e} (limit 1e-2), launches {counts}")
    if not err < 0.01:
        fail("oracle backend gate on the card")
    if (any(counts[k][0] == 0 for k in back_k)
            or any(p != 0 for _, p in counts.values())):
        fail(f"oracle backend gate did not run through K1, K2 and K3: {counts}")

    params = init_params(seed=0)
    intr = np.array([60.0, 60.0, 48.0, 32.0], np.float32)
    tol = 2e-2 if bf16 else 1e-3
    sharded_counts = None
    for mode in modes:
        frames = small_frames(mode)
        cfg = small_config(DroidConfig).replace(compute_dtype=dtype, stereo=mode == "stereo",
                                                rgbd=mode == "rgbd", upsample=mode == "upsample")
        if mode == "sharded":
            cfg = cfg.replace(ba_shards=2, refresh_shards=2)
        runs = {}
        for device in ("cuda", "cpu"):
            ops.reset_counts()
            d = Droid(cfg, params=params, device=device)
            hist = []
            for t, (img, depth) in enumerate(frames):
                d.track(float(t), img, depth=depth, intrinsics=intr)
                hist.append((d.video.counter, d.frontend.graph.ii.copy(),
                             d.frontend.graph.jj.copy()))
            # terminate_eva moves the poses
            poses = d.video.poses[:d.video.counter].cpu().numpy().copy()
            traj = d.terminate_eva(iter([(float(t), img, intr)
                                         for t, (img, _) in enumerate(frames)]))
            up = None if d.video.disps_up is None else d.video.disps_up[:d.video.counter].cpu()
            runs[device] = (hist, poses, traj, up)
            if mode == "sharded" and device == "cuda":
                torch.cuda.synchronize()
                sharded_counts = ops.counts()
                check_counts(sharded_counts, f"the card-vs-CPU sharded run ({dtype})",
                             MAIN_KERNELS if not bf16 else MAIN_KERNELS_BF16, OFF_ENGINE)
        (h_gpu, p_gpu, tr_gpu, up_gpu), (h_cpu, p_cpu, tr_cpu, up_cpu) = runs["cuda"], runs["cpu"]
        same_graph = all(a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
                         for a, b in zip(h_gpu, h_cpu))
        dp = float(np.abs(p_gpu - p_cpu).max()) if p_gpu.shape == p_cpu.shape else float("inf")
        dt = float(np.abs(tr_gpu - tr_cpu).max()) if tr_gpu.shape == tr_cpu.shape else float("inf")
        n_self = int((h_gpu[-1][1] == h_gpu[-1][2]).sum())
        say("card-vs-cpu", f"{dtype} {mode} Droid.track 64x96, {N_SMALL} frames: keyframes "
                           f"{h_gpu[-1][0]} vs {h_cpu[-1][0]}, edges equal every frame: "
                           f"{same_graph} ({n_self} self-edges at the end), max |pose diff| "
                           f"{dp:.3e} (tol {tol:.0e}); terminate_eva (backend 2 + 3 steps, "
                           f"filler): trajectory {tr_gpu.shape}, max |diff| {dt:.3e} "
                           f"(tol {tol:.0e})")
        if not (same_graph and dp <= tol):
            fail(f"the card run and the CPU run of Droid.track disagree ({dtype} {mode})")
        if mode == "stereo" and n_self == 0:
            fail("the stereo card-vs-CPU graph has no self-edges")
        if not (tr_gpu.shape == (N_SMALL, 7) and np.isfinite(tr_gpu).all() and dt <= tol):
            fail(f"the card run and the CPU run of Droid.terminate_eva disagree ({dtype} {mode})")
        if mode == "upsample":
            same = up_gpu is not None and up_cpu is not None and up_gpu.shape == up_cpu.shape
            du = float((up_gpu - up_cpu).abs().max()) if same else float("inf")
            say("card-vs-cpu", f"{dtype} upsample: disps_up {tuple(up_gpu.shape) if same else None} "
                               f"of the kept keyframes after terminate_eva, max |diff| {du:.3e} "
                               f"(tol {tol:.0e})")
            if not (same and bool(torch.isfinite(up_gpu).all()) and du <= tol):
                fail(f"the card run and the CPU run disagree on disps_up ({dtype})")
    return sharded_counts


def check_counts(counts, what, kernels=MAIN_KERNELS, absent=()):
    """Every kernel of `kernels` launched, none of `absent`, and no plain
    version ran."""
    for name, (launches, plain) in counts.items():
        if (name in kernels and launches == 0) or (name in absent and launches) or plain != 0:
            fail(f"{name}: {launches} kernel launches, {plain} plain calls on {what}")


def check_graph_counts(counts, what):
    """The C++ graph library's entry points (native.py) each called, and none
    of their numpy plain versions."""
    say("graph-lib", f"{what}: calls (library, numpy plain version) {counts}")
    for name, (lib, plain) in counts.items():
        if lib == 0 or plain != 0:
            fail(f"graph library {name}: {lib} library calls, {plain} numpy calls on {what}")


class Selections:
    """The inputs of every native.proximity_select call while installed,
    the distance matrix copied (the library writes into its own copy): the
    engine's edge selections, to hold the C++ library against its numpy
    plain version on the main path's own data."""

    def __init__(self):
        from droid_slam_reserch_tpu_torch import native

        self.native, self.orig, self.calls = native, native.proximity_select, []

        def select(d, *args):
            self.calls.append((np.array(d, np.float64), args))
            return self.orig(d, *args)

        native.proximity_select = select

    def restore(self):
        self.native.proximity_select = self.orig


def host_cpu():
    """The host's CPU model (lscpu, else /proc/cpuinfo), architecture and
    the cores this process may use."""
    import platform

    model = None
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=10).stdout
        model = next((ln.split(":", 1)[1].strip() for ln in out.splitlines()
                      if ln.strip().lower().startswith("model name")), None)
    except (OSError, subprocess.SubprocessError):
        pass
    if model is None:
        try:
            with open("/proc/cpuinfo") as f:
                model = next((ln.split(":", 1)[1].strip() for ln in f
                              if ln.lower().startswith(("model name", "cpu model"))), None)
        except OSError:
            pass
    return (f"{model or 'CPU model not reported'} ({platform.machine()}), "
            f"{len(os.sched_getaffinity(0))} cores")


def backend_distances(n, seed=0):
    """A distance matrix of n keyframes as the backend sees a long run: 0.3
    per keyframe of separation, plus uniform noise up to 4."""
    rng = np.random.RandomState(seed)
    i = np.arange(n)
    return 0.3 * np.abs(i[:, None] - i[None, :]) + 4.0 * rng.rand(n, n)


def phase_graph_library(front, back, cfg):
    """The C++ graph library (native.py) against its numpy plain version on
    the main path's captured selections: the last frontend selection of the
    fp32 mono track and the first backend selection of its terminate_eva,
    edge for edge and in order (where no two candidate distances tie: there
    the two sorts may order them apart, and the CPU tests hold the library
    against the JAX package's C++ path instead); then ms per call of both at
    the frontend's, the backend's and a 512-keyframe backend's size, on the
    card's host."""
    from droid_slam_reserch_tpu_torch import native

    times = {}
    n512 = backend_distances(512)
    cases = (("frontend", front), ("backend", back),
             ("backend 512", (n512, (0, 0, 512, cfg.backend_radius, cfg.backend_nms,
                                     cfg.backend_thresh, 16 * 512, np.zeros(0, np.int32),
                                     np.zeros(0, np.int32), False))))
    for what, (d, args) in cases:
        lib = native.proximity_select(d, *args)
        plain = native.proximity_select_plain(d, *args)
        t0, t1, t, rad, thresh = args[0], args[1], args[2], args[3], args[5]
        ii, jj = np.meshgrid(np.arange(t0, t), np.arange(t1, t), indexing="ij")
        cand = d[(ii - rad >= jj) & (d <= thresh)]           # the selectable distances
        tied = len(cand) - len(np.unique(cand))
        same = len(lib[0]) == len(plain[0]) and all(
            np.array_equal(a, b) for a, b in zip(lib, plain))
        ms = {}
        for name, fn in (("library", native.proximity_select),
                         ("numpy", native.proximity_select_plain)):
            reps = []
            for _ in range(5 if name == "library" else 3):
                start = time.perf_counter()
                fn(d, *args)
                reps.append(1e3 * (time.perf_counter() - start))
            ms[name] = float(np.median(reps))
        times[what] = dict(shape=list(d.shape), edges=len(lib[0]), tied_candidates=int(tied),
                           same_as_plain=same, **{f"{k}_ms": v for k, v in ms.items()})
        say("graph-lib", f"proximity_select at the {what}'s size {d.shape[0]}x{d.shape[1]} "
                         f"(rad {args[3]}, nms {args[4]}, thresh {thresh}, max_factors "
                         f"{args[6]}): {len(lib[0])} edges, library {ms['library']:.3f} ms, "
                         f"numpy {ms['numpy']:.3f} ms a call; equal to the numpy version in "
                         f"order: {same} ({tied} tied candidate distances)")
        if not same and tied == 0:
            fail(f"the graph library's edges differ from the numpy version's at the {what}'s "
                 f"selection")
    say("graph-lib", f"host: {host_cpu()}")
    return times


class EngineInputs:
    """The inputs of the engine's latest call of K1, K4 with the coords of
    the last K5 round on its windows, and K2 with the coords of the last K3
    lookup in its levels, taken while `phase` is set: by reference, with no
    copy and no host read, so the kernels can be held against their plain
    versions on the main path's own data afterwards.  The retained inputs
    (one call's features, at most two while the next call gathers its own)
    count in the peak memory printed while capturing."""

    def __init__(self):
        import weakref

        from droid_slam_reserch_tpu_torch.engine import factor_graph as fg
        from droid_slam_reserch_tpu_torch.ops import cuda_ba

        self.phase, self.seen, self._undo = None, {}, []
        seen = self.seen

        def patch(mod, name, wrap):
            self._undo.append((mod, name, getattr(mod, name)))
            setattr(mod, name, wrap(getattr(mod, name)))

        def k1(launch):
            def f(out, *args, **kw):
                if self.phase:
                    seen[self.phase, "K1"] = args[:7]
                return launch(out, *args, **kw)
            return f

        def build(fn, key):
            def f(f1, f2, *args):
                out = fn(f1, f2, *args)
                if self.phase:
                    first = out[0]                   # K4's windows, K2's level 0
                    seen[self.phase, key] = [f1, f2, args, weakref.ref(first), None]
                return out
            return f

        def lookup(fn, key):
            def f(src, *args):
                rec = seen.get((self.phase, key)) if self.phase else None
                first = src if key == "K4" else src[0]
                if rec is not None and rec[3]() is first:
                    rec[4] = args[1] if key == "K4" else args[0]   # the round's coords
                return fn(src, *args)
            return f

        patch(cuda_ba, "launch", k1)
        patch(fg, "corr_build_windows", lambda fn: build(fn, "K4"))
        patch(fg, "corr_lookup_windows", lambda fn: lookup(fn, "K4"))
        patch(fg, "corr_build", lambda fn: build(fn, "K2"))
        patch(fg, "corr_lookup", lambda fn: lookup(fn, "K2"))

    def during(self, phase, fn):
        """fn, with `phase` set while it runs (and the enclosing phase
        restored after it: the gated frontend's probe runs inside track)."""
        def f(*args, **kw):
            outer, self.phase = self.phase, phase
            try:
                return fn(*args, **kw)
            finally:
                self.phase = outer
        return f

    def restore(self):
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)

    def retained_mib(self):
        ts = [x for v in self.seen.values() for x in (v if isinstance(v, tuple) else v[:2] + v[4:])
              if hasattr(x, "nbytes")]
        return sum(t.nbytes for t in {id(t): t for t in ts}.values()) / 2**20


def hold_engine_inputs(torch, cap, what, stereo):
    """Each kernel that the capture saw, against its plain version on the
    captured inputs: K1 (2e-4 * max(1, |ref|) per output); K4's bases
    exactly and windows, K5 on the last round's coords, K2's levels and K3
    on K2's levels (fp32: 1e-5 * max(1, |ref|); bf16 windows, K5 and bf16
    levels: one rounding step, BF16 * |ref|).  The filler's K1 is held
    against the plain version in fp64 (hold_k1).  A stereo capture must
    hold self-edges in each K1 batch but the filler's (whose edges join a
    keyframe to a new frame)."""
    from droid_slam_reserch_tpu_torch.ops import cuda_corr

    for (phase, key), rec in sorted(cap.seen.items()):
        at = f"{what} {phase}"
        if key == "K1":
            ii, jj = rec[5], rec[6]
            n_self = int((ii == jj).sum())
            hold_k1(torch, rec, f"on the {at}'s last BA: N={ii.numel()}, {n_self} edges with "
                                f"ii == jj (self-edges and padding)", exact=phase == "filler")
            if stereo and phase != "filler" and n_self <= int(((ii == 0) & (jj == 0)).sum()):
                fail(f"K1 on the {at} saw no stereo self-edge")
            continue
        f1, f2, args, _, coords = rec
        if coords is None and key == "K4":
            coords = args[0]                       # no windowed round: K5 at the first coords
        E, H2, W2 = f2.shape[:3]
        if key == "K4":
            wins, bases = cuda_corr.corr_build_windows(f1, f2, *args)
            pwins, pbases = cuda_corr.corr_build_windows_plain(f1, f2, *args)
            out5 = cuda_corr.corr_lookup_windows(wins, bases, coords, (H2, W2))
            ref5 = cuda_corr.corr_lookup_windows_plain(wins, bases, coords, (H2, W2))
            pairs = (("K4 windows", wins, pwins), ("K5", out5, ref5))
            same = bool((bases == pbases).all())
        else:
            levels = cuda_corr.corr_build(f1, f2, *args)
            plain = cuda_corr.corr_build_plain(f1, f2, *args)
            pairs = tuple((f"K2 level {l}", a, b) for l, (a, b) in enumerate(zip(levels, plain)))
            if coords is not None:
                pairs += (("K3", cuda_corr.corr_lookup(levels, coords),
                           cuda_corr.corr_lookup_plain(levels, coords)),)
            same = True
        torch.cuda.synchronize()
        errs = []
        for name, a, b in pairs:
            if b.numel() == 0:                     # a level coarser than the image
                errs.append((name, 0.0 if a.shape == b.shape else float("inf"), 0.0))
                continue
            scale = float(b.float().abs().max())
            tol = BF16 * scale if b.dtype == torch.bfloat16 else 1e-5 * max(1.0, scale)
            errs.append((name, float((a.float() - b.float()).abs().max()), tol))
        say("engine-inputs", f"{key}{'' if key == 'K4' else ' + K3'} on the {at}'s last call "
                             f"(E={E}, {H2}x{W2}, {f1.dtype}): " + ", ".join(
                                 f"{n} {e:.3e} (tol {t:.1e})" for n, e, t in errs)
                             + ("" if key == "K2" else f"; bases equal {same}"))
        if not (same and all(e <= t for _, e, t in errs)):
            fail(f"{key} disagrees with its plain version on the {at}'s inputs")


def phase_main_path(torch, ops, frames, dtype="float32", kernels=MAIN_KERNELS, mode="mono",
                    depths=None, capture=None):
    """Droid.track over full-size frames in the compute dtype: mono and
    stereo with EUROC_CONFIG (320x512), RGB-D with ETH3D_CONFIG (480x640)
    and `depths`; returns the kernel counts, the Droid, the tracked (tstamp,
    image) pairs and the frames/s after initialisation.  With `capture`
    (EngineInputs), the track's kernel inputs are kept."""
    from droid_slam_reserch_tpu_torch import native
    from droid_slam_reserch_tpu_torch.engine import Droid
    from droid_slam_reserch_tpu_torch.engine import factor_graph as fg
    from droid_slam_reserch_tpu_torch.utils import ETH3D_CONFIG, EUROC_CONFIG

    name, base = (("ETH3D_CONFIG", ETH3D_CONFIG) if mode == "rgbd"
                  else ("EUROC_CONFIG", EUROC_CONFIG))
    cfg = base.replace(filter_thresh=-1.0, keyframe_thresh=0.0, compute_dtype=dtype,
                       stereo=mode == "stereo")
    intr = INTR_ETH3D if mode == "rgbd" else INTR_EUROC
    n_frames = len(frames)
    droid = Droid(cfg, device="cuda")
    track = droid.track if capture is None else capture.during("track", droid.track)
    torch.cuda.synchronize()

    ops.reset_counts()
    native.reset_counts()
    fg.reset_corr_rounds()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    t_init = None
    for t, img in enumerate(frames):
        track(float(t), img, depth=None if depths is None else depths[t], intrinsics=intr)
        if t_init is None and droid.frontend.is_initialized:
            torch.cuda.synchronize()
            t_init = (time.time(), t + 1, droid.video.counter, fg.corr_rounds())
    torch.cuda.synchronize()
    t1 = time.time()
    counts = ops.counts()
    graph_counts = native.counts()
    if t_init is None:
        fail("the frontend never initialised on the main path")

    v = droid.video
    n_kf = v.counter
    poses, disps = v.poses[:n_kf], v.disps[:n_kf]
    finite = bool(torch.isfinite(poses).all() and torch.isfinite(disps).all())
    steady = n_frames - t_init[1]
    fps_all = n_frames / (t1 - t0)
    fps_steady = steady / (t1 - t_init[0]) if steady > 0 else float("nan")
    rounds = fg.corr_rounds()
    steady_rounds = sum(rounds.values()) - sum(t_init[3].values())
    steady_kf = n_kf - t_init[2]
    say("main-path", f"track: {name} {mode} {cfg.image_size[0]}x{cfg.image_size[1]} {dtype}: "
                     f"{n_frames} frames, {n_kf} "
                     f"keyframes, {len(droid.frontend.graph.ii)} active edges; {fps_all:.2f} "
                     f"frames/s and {n_kf / (t1 - t0):.2f} keyframes/s overall, {fps_steady:.2f} "
                     f"frames/s after initialisation; peak memory "
                     f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say("main-path", f"track: correlation rounds {rounds} (one host read of the drift rule "
                     f"each; {steady_rounds / max(steady_kf, 1):.2f} per keyframe after "
                     f"initialisation); counts (kernel launches, plain calls): {counts}")
    if not finite:
        fail("non-finite poses or disparities on the main path")
    if n_kf < cfg.warmup:
        fail(f"only {n_kf} keyframes (< warmup {cfg.warmup})")
    if droid.video.fmaps.dtype != getattr(torch, dtype):
        fail(f"the features are {droid.video.fmaps.dtype}, not {dtype}")
    g = droid.frontend.graph
    if mode == "stereo":
        n_self = int((g.ii == g.jj).sum()) + int((g.ii_inac == g.jj_inac).sum())
        say("main-path", f"track: {n_self} stereo self-edges in the graph (active and inactive), "
                         f"fmaps {tuple(v.fmaps.shape)}")
        if n_self == 0 or v.fmaps.shape[1] != 2:
            fail("the stereo main path has no self-edges or no right camera")
    if mode == "rgbd":
        sens = v.disps_sens[:n_kf]
        say("main-path", f"track: disps_sens of {n_kf} keyframes in [{float(sens.min()):.4f}, "
                         f"{float(sens.max()):.4f}]")
        if not bool((sens > 0).all()):
            fail("the RGB-D main path has keyframes without sensor disparity")
    check_counts(counts, f"the main path's track ({mode}, {dtype})", kernels, OFF_ENGINE)
    check_graph_counts(graph_counts, f"the main path's track ({mode}, {dtype})")
    return counts, droid, [(float(t), img) for t, img in enumerate(frames)], fps_steady


class Timed:
    """Wraps a callable; records the seconds and the peak device memory
    (GiB) of each call, synchronised."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.seconds, self.peak = torch, fn, [], []

    def __call__(self, *args, **kw):
        cuda = self.torch.cuda
        cuda.synchronize()
        cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = self.fn(*args, **kw)
        cuda.synchronize()
        self.seconds.append(time.time() - t0)
        self.peak.append(cuda.max_memory_allocated() / 2**30)
        return out


def phase_terminate(torch, ops, droid, tracked, profiling=False, kernels=MAIN_KERNELS,
                    intr=INTR_EUROC, capture=None):
    """Droid.terminate_eva over every tracked frame: the backend's two runs
    and the trajectory filler, timed apart on the host clock.  With
    profiling, the call runs under torch.profiler (whose overhead then
    enters the host-clock times).  With `capture`, the backend's kernel
    inputs are kept.  Returns the kernel counts, the call's seconds and the
    trajectory."""
    from droid_slam_reserch_tpu_torch import native
    from droid_slam_reserch_tpu_torch.engine import factor_graph as fg

    n_kf = droid.video.counter
    runs = droid.backend.runs
    run = droid.backend if capture is None else capture.during("backend", droid.backend)
    backend = droid.backend = Timed(torch, run)
    backend.runs = runs
    filler = droid.traj_filler = Timed(torch, droid.traj_filler)
    call = Timed(torch, droid.terminate_eva)
    stream = iter([(t, img, intr) for t, img in tracked])
    ops.reset_counts()
    native.reset_counts()
    fg.reset_corr_rounds()
    tag = "" if droid.cfg.compute_dtype == "float32" else "_bf16"
    if profiling:
        traj = profiled(torch, lambda: call(stream), f"terminate_eva {droid.cfg.compute_dtype}",
                        1, "call", f"profile_terminate{tag}.txt")
    else:
        traj = call(stream)
    counts = ops.counts()
    graph_counts = native.counts()
    rounds = fg.corr_rounds()
    mode = "stereo" if droid.cfg.stereo else "rgbd" if droid.cfg.rgbd else "mono"
    say("main-path", f"terminate_eva {mode} {droid.cfg.compute_dtype}: {call.seconds[0]:.2f} s: "
                     f"backend {backend.seconds[0]:.2f} s "
                     f"({droid.cfg.backend_steps_first} steps, {runs[0]}) + "
                     f"{backend.seconds[1]:.2f} s ({droid.cfg.backend_steps_second} steps, "
                     f"{runs[1]}), filler {filler.seconds[0]:.2f} s over {len(tracked)} frames "
                     f"and {n_kf} keyframes; peak memory: backend {max(backend.peak):.2f} GiB, "
                     f"filler {filler.peak[0]:.2f} GiB")
    say("main-path", f"terminate_eva: filler correlation rounds {rounds}; counts (kernel "
                     f"launches, plain calls): {counts}")
    q = np.linalg.norm(traj[:, 3:], axis=1) if traj.ndim == 2 else np.zeros(0)
    say("main-path", f"terminate_eva: trajectory {traj.shape}, finite {bool(np.isfinite(traj).all())}, "
                     f"|q| in [{q.min():.6f}, {q.max():.6f}]")
    if not (traj.shape == (len(tracked), 7) and np.isfinite(traj).all()
            and np.abs(q - 1.0).max() < 1e-3):
        fail("terminate_eva did not return a finite trajectory of unit quaternions")
    check_counts(counts, f"the main path's terminate_eva ({mode}, {droid.cfg.compute_dtype})",
                 kernels, OFF_ENGINE)
    check_graph_counts(graph_counts, f"the main path's terminate_eva ({mode}, "
                                     f"{droid.cfg.compute_dtype})")
    return counts, call.seconds[0], traj


def phase_profile_frontend(torch, ops, dtype="float32"):
    """tools/profile_frontend.py at bench.py's shape on the card, in the
    compute dtype; returns the kernel counts of the run.  Its lookups are
    held against the plain lookup: fp32 within 1e-5; bf16 K3 within one
    rounding step of the largest magnitude, and K6 (over the plain bf16
    P-major pyramid) and K5 (over K7's windows of K2's levels) within two,
    since the plain lookup reads K2's levels, whose sums round apart from
    the plain build's."""
    from droid_slam_reserch_tpu_torch.engine import factor_graph as fg
    from droid_slam_reserch_tpu_torch.tools.profile_frontend import FULL, ROUNDS, profile

    ops.reset_counts()
    fg.reset_corr_rounds()
    res = profile(**FULL, device="cuda", iters=10, dtype=dtype)
    torch.cuda.synchronize()
    counts, rounds = ops.counts(), fg.corr_rounds()
    torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    say("profile-frontend", f"{dtype}: correlation rounds of fused_rounds {rounds}; counts "
                            f"(kernel launches, plain calls): {counts}")
    if dtype == "float32":
        tols = dict(k3_max_err=1e-5, k6_max_err=1e-5, k5_max_err=1e-5)
        kernels = tuple(k for k in counts if "bf16" not in k)
    else:
        m = res["lookup_ref_max"]
        tols = dict(k3_max_err=BF16 * m, k6_max_err=2 * BF16 * m, k5_max_err=2 * BF16 * m)
        kernels = ("ba_blocks", "corr_build_bf16", "corr_lookup_bf16", "corr_build_windows_bf16",
                   "corr_lookup_windows_bf16", "corr_lookup_pmajor_bf16",
                   "corr_extract_windows_bf16", "corr_build_windows_levels_bf16")
    if not all(res[k] <= t for k, t in tols.items()):
        fail(f"a lookup of the profiler disagrees with the plain one: "
             f"{ {k: res[k] for k in tols} } against {tols}")
    if rounds["fallback"] or rounds["windowed"] % ROUNDS:
        fail(f"fused_rounds left the window cache in the profiler: {rounds}")
    check_counts(counts, f"the frontend profiler ({dtype})", kernels=kernels)
    return counts


KERNEL_GROUPS = (      # substrings of device kernel names -> group, first match wins
    ("layout transposes NCHW<->NHWC", ("nchwtonhwc", "nhwctonchw")),
    ("port K2 corr_build", ("corr_build_kernel", "corr_build_bf16_kernel")),
    ("port K3 corr_lookup", ("corr_lookup_kernel", "corr_lookup_bf16_kernel")),
    ("port K4 corr_build_windows", ("windows_build_kernel", "windows_build_bf16_kernel")),
    ("port K5 corr_lookup_windows",
     ("windows_lookup_kernel", "windows_lookup_bf16_kernel")),
    ("port K6 corr_lookup_pmajor", ("pmajor_lookup_kernel", "pmajor_lookup_bf16_kernel")),
    ("port K7 corr_extract_windows", ("extract_windows_kernel", "extract_windows_bf16_kernel")),
    ("port K1 ba_blocks", ("ba_blocks_kernel",)),
    ("convolutions (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "winograd", "fft", "_complex")),
    ("matrix products (cuBLAS)", ("gemm", "gemv", "cutlass")),
    ("Cholesky (cuSOLVER)", ("potrf", "potrs", "trsm", "cholesky", "syrk")),
    ("copies and fills", ("memcpy", "memset", "copy", "fill")),
)


def profiled(torch, fn, what, per, unit, filename):
    """Run fn under torch.profiler; print the wall time, the device's busy
    and idle share and the device time by kernel group, each divided by
    `per` `unit`s, and write the full tables to chiprun_out/filename."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    avgs = prof.key_averages()
    dev = sorted(((e.self_device_time_total, e.count, e.key) for e in avgs
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                 reverse=True)
    busy_us = sum(us for us, _, _ in dev)
    if busy_us == 0:
        fail("torch.profiler recorded no device time")
    groups, launches = {}, {}
    for us, n, name in dev:
        low = name.lower()
        g = next((g for g, keys in KERNEL_GROUPS if any(s in low for s in keys)), "other kernels")
        groups[g] = groups.get(g, 0.0) + us
        launches[g] = launches.get(g, 0) + n
    say("profile", f"{what} under torch.profiler: wall {wall_us / 1e3 / per:.1f} ms per {unit}, "
                   f"device busy {busy_us / 1e3 / per:.1f} ms ({100 * busy_us / wall_us:.1f} %), "
                   f"idle {100 * (1 - busy_us / wall_us):.1f} %")
    say("profile", f"device time per {unit} by group: " + "; ".join(
        f"{g} {us / 1e3 / per:.2f} ms" for g, us in sorted(groups.items(), key=lambda x: -x[1])))
    say("profile", f"launches in the run by group: " + "; ".join(
        f"{g} {n}" for g, n in sorted(launches.items(), key=lambda x: -x[1])))
    path = os.path.join(OUT_DIR, filename)
    with open(path, "w") as f:
        f.write(f"{what}: wall {wall_us:.0f} us, device busy {busy_us:.0f} us\n\n")
        f.write("device kernels by total time (us, count, name):\n")
        for us, n, name in dev:
            f.write(f"{us:12.1f} {n:7d}  {name[:160]}\n")
        f.write("\n" + avgs.table(sort_by="self_cpu_time_total", row_limit=40))
    say("profile", f"tables in {os.path.relpath(path, REPO)}")
    return out


def phase_profile(torch, droid, frames, t_base, intr=INTR_EUROC, tag=""):
    """Where a steady-state keyframe's time goes, after the main path's track.

    The frames get timestamps from t_base on.  The first half of `frames`
    is tracked with the motion filter and the frontend timed apart on the
    host clock (each ends in a synchronize); the second half runs
    Droid.track under torch.profiler.  Returns the tracked (tstamp, image)
    pairs.
    """
    half = len(frames) // 2
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

    def track_rest():
        for k, img in enumerate(rest):
            droid.track(t_base + half + k, img, intrinsics=intr)

    profiled(torch, track_rest, f"{len(rest)} keyframes {droid.cfg.compute_dtype}", len(rest),
             "keyframe", f"profile_main_path{tag}.txt")
    return [(t_base + k, img) for k, img in enumerate(frames)]


def png_filter(rows, bpp, kinds):
    """PNG row filtering: rows [H, N] bytes, kinds [H] each row's filter
    (0 none, 1 sub, 2 up, 3 average, 4 paeth) -> the filtered bytes."""
    x = rows.astype(np.int16)
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, bpp:], b[1:], c[1:, bpp:] = x[:, :-bpp], x[:-1], x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])[kinds, np.arange(len(x))]
    return ((x - pred) & 255).astype(np.uint8)


def write_png(path, img, mixed=False):
    """A PNG of every row filtered with filter 0 (none), or with mixed row
    r with filter r % 5 (as libpng's adaptive filtering mixes them), zlib
    level 1: img [H, W] uint8 or uint16 grey, or [H, W, 3] uint8 BGR
    (stored as RGB)."""
    import struct
    import zlib

    img = np.asarray(img)
    depth = 16 if img.dtype == np.uint16 else 8
    ctype = 2 if img.ndim == 3 else 0
    rows = (img[..., ::-1] if ctype == 2 else img).astype(">u2" if depth == 16 else np.uint8)
    rows = rows.reshape(img.shape[0], -1).view(np.uint8)
    kinds = np.arange(img.shape[0]) % 5 if mixed else np.zeros(img.shape[0], np.int64)
    if mixed:
        rows = png_filter(rows, (3 if ctype == 2 else 1) * depth // 8, kinds)
    raw = np.concatenate([kinds.astype(np.uint8)[:, None], rows], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


N_CLI = 16          # frames of the tum, tartanair and demo runs
N_CLI_ETH3D = 24    # ETH3D_CONFIG's warmup is 20


def make_cli_datasets(root):
    """The datasets' on-disk layouts at their raw sizes, of euroc_frames'
    panning texture (and depth_frames' depth): EuRoC (752x480 8-bit grey
    cam0 and cam1, the right view 6 px along, data.csv ground truth, and
    the same frames with mixed row filters in a second sequence), TUM fr1 (640x480 RGB and 16-bit depth, stride 2), ETH3D (739x458 RGB,
    16-bit depth, calibration.txt, groundtruth.txt), TartanAir (640x480
    RGB, NED pose_left.txt) and a demo directory (640x480 with a
    5-coefficient calibration).  Returns the paths."""
    j = os.path.join
    paths = {}

    mav0 = paths["euroc"] = j(root, "MH_synth", "mav0")
    mixed = paths["euroc_mixed"] = j(root, "MH_synth_mixed", "mav0")
    for d in ("cam0/data", "cam1/data", "state_groundtruth_estimate0"):
        os.makedirs(j(mav0, d))
    for d in ("cam0/data", "cam1/data"):
        os.makedirs(j(mixed, d))
    t0, dt = 1403636579763555584, 50_000_000
    with open(j(mav0, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
        for t, pair in enumerate(euroc_frames(N_MAIN, seed=3, H=480, W=752, shift=STEREO_SHIFT)):
            ts = t0 + t * dt
            for seq, filtered in ((mav0, False), (mixed, True)):
                write_png(j(seq, "cam0/data", f"{ts}.png"), pair[0][..., 0], filtered)
                write_png(j(seq, "cam1/data", f"{ts}.png"), pair[1][..., 0], filtered)
            f.write(f"{ts},{0.05 * t},{0.01 * t},0.0,1.0,0.0,0.0,0.0\n")

    def rgbd_sequence(name, n, H, W, scale, calib=None, fmt="{:.6f}"):
        seq = paths[name] = j(root, name)
        os.makedirs(j(seq, "rgb"))
        os.makedirs(j(seq, "depth"))
        rows = []
        imgs, depths = euroc_frames(n, seed=4, H=H, W=W), depth_frames(n, seed=4, H=H, W=W)
        for t, (img, depth) in enumerate(zip(imgs, depths)):
            ts = 1305031102.175 + 0.033 * t
            write_png(j(seq, "rgb", fmt.format(ts) + ".png"), img)
            write_png(j(seq, "depth", fmt.format(ts) + ".png"), (depth * scale).astype(np.uint16))
            rows.append([ts, 0.02 * t, 0.0, 0.01 * t, 0.0, 0.0, 0.0, 1.0])
        np.savetxt(j(seq, "groundtruth.txt"), np.asarray(rows), fmt="%.6f")
        if calib is not None:
            np.savetxt(j(seq, "calibration.txt"), np.asarray(calib)[None])

    rgbd_sequence("tum", 2 * N_CLI, 480, 640, 5000.0)
    rgbd_sequence("eth3d", N_CLI_ETH3D, 458, 739, 1000.0, [726.28, 726.28, 354.65, 186.47])

    scene = paths["tartanair"] = j(root, "tartanair", "P001")
    os.makedirs(j(scene, "image_left"))
    for t, img in enumerate(euroc_frames(N_CLI, seed=5, H=480, W=640)):
        write_png(j(scene, "image_left", f"{t:06d}_left.png"), img)
    np.savetxt(j(scene, "pose_left.txt"),
               np.asarray([[0.0, 0.1 * t, 0.0, 0.0, 0.0, 0.0, 1.0] for t in range(N_CLI)]))

    demo = paths["demo"] = j(root, "demo")
    os.makedirs(j(demo, "imgs"))
    for t, img in enumerate(euroc_frames(N_CLI, seed=6, H=480, W=640)):
        write_png(j(demo, "imgs", f"{t:04d}.png"), img)
    with open(j(demo, "calib.txt"), "w") as f:
        f.write("520.0 520.0 319.5 239.5 -0.05 0.02 0.0005 -0.0003 0.0\n")
    return paths


TIMED_PARTS = ("track", "terminate", "terminate_eva_second", "save_reconstruction")


def run_command(torch, argv, cap):
    """cli.main(argv) in process with its stdout captured.  The engine's
    track, backend (terminate, which SDroid inherits), filler
    (terminate_eva_second) and the gated frontend's probe run under `cap`'s
    phases (EngineInputs), and every call of TIMED_PARTS is timed,
    synchronised on both sides.
    Returns (what cli.main returned, the printed text, seconds, seconds by
    part)."""
    import contextlib
    import io

    from droid_slam_reserch_tpu_torch import cli
    from droid_slam_reserch_tpu_torch.engine import Droid, FactorGraph

    spent = {}
    patches = ((Droid, "track", "track"), (Droid, "terminate", "backend"),
               (Droid, "terminate_eva_second", "filler"),
               (Droid, "save_reconstruction", None), (FactorGraph, "probe_quality", "probe"))
    originals = [(cls, attr, cls.__dict__[attr]) for cls, attr, _ in patches]

    def wrap(attr, phase, fn):
        fn = fn if phase is None else cap.during(phase, fn)
        if attr not in TIMED_PARTS:
            return fn

        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[attr] = spent.get(attr, 0.0) + time.time() - t0
            return out
        return call

    for (cls, attr, phase), (_, _, fn) in zip(patches, originals):
        setattr(cls, attr, wrap(attr, phase, fn))
    printed = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(printed):
            out = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        for cls, attr, fn in originals:
            setattr(cls, attr, fn)
        cap.restore()
    return out, printed.getvalue(), time.time() - t0, spent


def phase_cli(torch, ops, paths, root):
    """The port's CLI, in process (cli.main), on the datasets that
    make_cli_datasets wrote into `root`, a temporary directory outside the
    repository (`paths`), writing its outputs there too: euroc mono with
    --upsample, --out and --gt in fp32 and in bf16
    (--reconstruction_path runs in the multisession phase), euroc --stereo
    in bf16, then tum, eth3d --depth, tartanair and demo in bf16,
    each with --filter_thresh -1 --keyframe_thresh 0 (random weights).
    Around each command the counts are set to 0 and read: K1-K5 of the
    dtype launch, no plain version runs, none of K6-K8.  Each command's
    last K1, K4 + K5 and K2 + K3 inputs of its track, backend and filler
    are captured (EngineInputs) and each kernel is held against its plain
    version on them.  Each must print a finite ATE where there is ground
    truth; the upsampled runs keep finite disps_up on every keyframe.
    Prints each command's frames/s end to end and its seconds split into
    Droid.track, the backend (Droid.terminate), the filler with its
    stream's reads (terminate_eva_second), save_reconstruction and the rest
    (the tracked frames' reads, the keyframe export, the ATE), each call
    synchronised; the engine's sections and host syncs (utils/timing); its
    peak memory; and the EuRoC readers' ms a frame alone, on filter-0 PNGs
    and on PNGs of mixed row filters (whose frames must be the same bytes).
    Returns the counts by path and each command's seconds in Droid.track."""
    from droid_slam_reserch_tpu_torch.data import euroc_stream
    from droid_slam_reserch_tpu_torch.utils import timing

    for stereo in (False, True):
        frames = {}
        for kind in ("euroc", "euroc_mixed"):
            t0 = time.time()
            frames[kind] = [img for _, img, _ in euroc_stream(paths[kind], stereo=stereo)]
            n = len(frames[kind])
            say("cli", f"readers: euroc_stream {'stereo' if stereo else 'mono'} 752x480 grey "
                       f"-> 320x512, {'mixed row filters 0-4' if kind == 'euroc_mixed' else 'filter 0'}: "
                       f"{1e3 * (time.time() - t0) / n:.2f} ms a frame over {n} frames")
        if not all(np.array_equal(a, b) for a, b in zip(*frames.values())):
            fail("euroc_stream gives other frames from the PNGs of mixed row filters")
        del frames
    out = os.path.join(root, "out")
    os.makedirs(out)
    random_weights = ["--filter_thresh", "-1", "--keyframe_thresh", "0"]
    runs = [
        ("euroc", "float32", N_MAIN, "ate",
         ["euroc", "--datapath", paths["euroc"], "--upsample",
          "--out", out + "/euroc.txt",
          "--gt", paths["euroc"] + "/state_groundtruth_estimate0/data.csv"]),
        ("euroc", "bfloat16", N_MAIN, "ate",
         ["euroc", "--datapath", paths["euroc"], "--upsample", "--out", out + "/euroc16.txt",
          "--gt", paths["euroc"] + "/state_groundtruth_estimate0/data.csv"]),
        ("euroc_stereo", "bfloat16", N_MAIN, "ate",
         ["euroc", "--datapath", paths["euroc"], "--stereo", "--out", out + "/stereo.txt",
          "--gt", paths["euroc"] + "/state_groundtruth_estimate0/data.csv"]),
        ("tum", "bfloat16", N_CLI, "ate",
         ["tum", "--datapath", paths["tum"], "--gt", paths["tum"] + "/groundtruth.txt"]),
        ("eth3d", "bfloat16", N_CLI_ETH3D, "ate", ["eth3d", "--datapath", paths["eth3d"], "--depth"]),
        ("tartanair", "bfloat16", N_CLI, "ate_score",
         ["tartanair", "--datapath", paths["tartanair"],
          "--gt", paths["tartanair"] + "/pose_left.txt"]),
        ("demo", "bfloat16", N_CLI, None,
         ["demo", "--imagedir", paths["demo"] + "/imgs", "--calib", paths["demo"] + "/calib.txt"]),
    ]
    by_path, track_s, summary = {}, {}, []
    for name, dtype, n_frames, key, argv in runs:
        argv = argv + random_weights + (["--bf16"] if dtype == "bfloat16" else [])
        kernels = MAIN_KERNELS if dtype == "float32" else MAIN_KERNELS_BF16
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        timing.reset()
        timing.enable()
        cap = EngineInputs()
        try:
            droid, printed, secs, spent = run_command(torch, argv, cap)
        finally:
            timing.disable()
        split = ", ".join(f"{part} {spent.get(part, 0.0):.2f}" for part in TIMED_PARTS)
        counts = ops.counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        lines = [ln for ln in printed.splitlines() if ln.startswith(("{", "tracked"))]
        res = [json.loads(ln) for ln in lines if ln.startswith("{")]
        v = droid.video
        shape = f"{droid.cfg.image_size[0]}x{droid.cfg.image_size[1]}"
        say("cli", f"{name} {dtype} {shape}: {n_frames} frames, {v.counter} keyframes in {secs:.2f} s, "
                   f"{n_frames / secs:.2f} frames/s end to end; s: {split}, rest "
                   f"{secs - sum(spent.values()):.2f}; peak memory {peak:.2f} GiB; "
                   f"printed {lines}")
        say("cli", f"{name} {dtype}: counts (kernel launches, plain calls): {counts}")
        sections, syncs = timing.totals(), timing.counters().get("host_syncs", 0)
        say("cli", f"{name} {dtype}: {syncs} host syncs ({syncs / n_frames:.2f} a frame); "
                   f"sections (host s, calls, device s): "
                   + ", ".join(f"{k} {h / 1e3:.2f} {c} "
                               + ("-" if d is None else f"{d / 1e3:.2f}")
                               for k, (c, h, d) in sorted(sections.items())))
        if key is not None:
            vals = [r[key]["rmse"] if key == "ate" else r[key] for r in res if key in r]
            if not (vals and np.isfinite(vals[-1])):
                fail(f"cli {name} {dtype} printed no finite {key}")
        up = None
        if "--upsample" in argv:
            up = v.disps_up
            if up is None or not bool(torch.isfinite(up[:v.counter]).all()):
                fail(f"cli {name} {dtype}: disps_up not finite on the kept keyframes")
            say("cli", f"{name} {dtype}: disps_up {tuple(up.shape)} ({up.numel() * 4 / 2**30:.2f} "
                       f"GiB), finite on the {v.counter} kept keyframes, in "
                       f"[{float(up[:v.counter].min()):.4f}, {float(up[:v.counter].max()):.4f}]")
        if "--out" in argv:
            traj = np.loadtxt(argv[argv.index("--out") + 1])
            if not (traj.shape == (n_frames, 8) and np.isfinite(traj).all()):
                fail(f"cli {name} {dtype}: trajectory file {traj.shape}")
        check_counts(counts, f"the cli's {name} ({dtype})", kernels, OFF_ENGINE)
        by_path[f"cli_{name}" + ("" if dtype == "float32" else "_bf16")] = counts
        track_s[f"cli_{name}" + ("" if dtype == "float32" else "_bf16")] = spent.get("track", 0.0)
        summary.append(f"{name} {dtype} {n_frames / secs:.2f} frames/s, {peak:.2f} GiB")
        del droid, v, up
        torch.cuda.empty_cache()
        say("engine-inputs", f"cli {name} {dtype}: {cap.retained_mib():.1f} MiB of kernel "
                             f"inputs retained by the capture")
        hold_engine_inputs(torch, cap, f"cli {name} {dtype}", name == "euroc_stereo")
        del cap
    say("cli", "end to end: " + "; ".join(summary))
    return by_path, track_s


# the multisession sessions: every 4th frame of the cli's 40-frame EuRoC sequence, 10
# frames, initialised after 8 (EUROC_CONFIG's warmup of 15 exceeds them)
MS_STRIDE, MS_WARMUP = 4, 8
N_LOOP = 10        # session A's keyframes a loop group replays: 5 seeds, then 5 tracked
STATE_KEYS = ("tstamps", "images", "poses", "disps", "disps_sens", "intrinsics", "fmaps", "nets",
              "inps")      # reconstruction.npz, as the JAX package writes it
T_KNOWN_XI = [2.0, -1.0, 0.5, 0.05, -0.1, 0.08]   # B = T_known * A, as the JAX package's test


def write_imagedir(path, images, intr):
    """images as PNGs `path`/0000.png ...; returns the calibration file
    (fx fy cx cy at the images' size) written beside the directory."""
    os.makedirs(path)
    for t, img in enumerate(images):
        write_png(os.path.join(path, f"{t:04d}.png"), img)
    calib = path + ".txt"
    with open(calib, "w") as f:
        f.write(" ".join(f"{x:.6f}" for x in intr) + "\n")
    return calib


def ms_kernels(stage, dtype):
    """The kernels a multisession stage must launch: the main path's for
    tracking stages, the gated frontend's probe (K2 and K3 in the compute
    dtype) for --improve, the backend's for fusion, the filler's for the
    evaluation, none for view."""
    bf16 = dtype == "bfloat16"
    front = FRONTEND_KERNELS_BF16 if bf16 else FRONTEND_KERNELS
    back = BACKEND_KERNELS_BF16 if bf16 else BACKEND_KERNELS
    probe = ("corr_build_bf16", "corr_lookup_bf16") if bf16 else ("corr_build", "corr_lookup")
    return {"euroc": front + back, "euroc_viewer": front + back, "align": front + back,
            "improve_shut": front + back + probe, "improve": front + back + probe,
            "fuse": back, "evaluate": front, "view": ()}[stage]


def phase_multisession(torch, ops, paths, root, dtype, cli_track=None):
    """The multisession path and the viewer through the port's CLI (cli.main,
    in process), EUROC_CONFIG stereo at 320x512, in the compute dtype:
    1. euroc --stereo --stride 4 --warmup 8 --reconstruction_path A
       --vis_path (session A: 10 frames of the cli's EuRoC sequence); with
       `cli_track`, the seconds in Droid.track of the cli phase's 40-frame
       euroc --stereo (bf16), also that command with --vis_path (and
       without its outputs), for track frames/s with and without the viewer;
    2. session B = A displaced by a known SE3 T_known (chip_smoke writes it);
    3. multisession-align A B, one loop group replaying A's first 10
       keyframes (5 seeds), then the joint backend: T must recover T_known
       at the JAX package's test tolerances;
    4. multisession-align --improve behind a shut gate (one group, rejected),
       then with the gate open over a reverse and a forward group
       (recovered, stitched);
    5. multisession --subsample 2 over A and the aligned B;
    6. multisession-evaluate of the fused map, one sequence per session,
       with a ground truth (a finite ATE);
    7. view --color_by_session over A, B and the fused map.
    Around each stage the counts are set to 0 and read: the stage's kernels
    launch, no plain version runs, none of K6-K8; each kernel is held
    against its plain version on the stage's last track, probe, backend and
    filler inputs (EngineInputs).  Prints each stage's seconds and peak
    memory, the fused keyframe count, track frames/s with and without the
    viewer, and the viewer's refreshes (refresh_once and _write driven here:
    the PLY must exist).  Returns the counts by path and session A."""
    from droid_slam_reserch_tpu_torch.lie import se3_exp, se3_mul

    bf16 = dtype == "bfloat16"
    sfx = "_bf16" if bf16 else ""
    d = os.path.join(root, "ms" + sfx)
    os.makedirs(d)
    flags = ["--stereo", "--filter_thresh", "-1", "--keyframe_thresh", "0"] + (
        ["--bf16"] if bf16 else [])
    by_path, track_s = {}, {}

    def stage(name, argv):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        cap = EngineInputs()
        out, printed, secs, spent = run_command(torch, argv, cap)
        counts = ops.counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        lines = printed.splitlines()
        res = [json.loads(ln) for ln in lines if ln.startswith("{")]
        track_s[name] = spent.get("track", 0.0)
        split = ", ".join(f"{part} {spent.get(part, 0.0):.2f}" for part in TIMED_PARTS)
        say("multisession", f"{name} {dtype}: {secs:.2f} s (s: {split}, rest "
                            f"{secs - sum(spent.values()):.2f}), peak memory {peak:.2f} GiB; "
                            f"printed {res or lines[-2:]}")
        say("multisession", f"{name} {dtype}: counts (kernel launches, plain calls): {counts}")
        check_counts(counts, f"the multisession {name} ({dtype})", ms_kernels(name, dtype),
                     OFF_ENGINE)
        by_path[f"multisession_{name}{sfx}"] = counts
        viewer = getattr(out, "viewer", None)        # euroc returns its Droid
        del out
        torch.cuda.empty_cache()
        if cap.seen:
            hold_engine_inputs(torch, cap, f"multisession {name} {dtype}", True)
        return res, lines, viewer

    # 1. session A with the live viewer
    a_dir, live = os.path.join(d, "a"), os.path.join(d, "live.ply")
    euroc = ["euroc", "--datapath", paths["euroc"]] + flags
    *_, v = stage("euroc", euroc + ["--stride", str(MS_STRIDE), "--warmup", str(MS_WARMUP),
                                    "--reconstruction_path", a_dir, "--vis_path", live])
    A = dict(np.load(os.path.join(a_dir, "reconstruction.npz")))
    K = len(A["poses"])
    kf = os.listdir(os.path.join(a_dir, "keyframes_cam0"))
    if not (K == len(kf) and sorted(A) == sorted(STATE_KEYS)):
        fail(f"session A: {sorted(A)}, {len(kf)} keyframe images for {K} keyframes ({dtype})")
    before = v.refreshes
    v.refresh_once()
    v._write()
    with open(live) as f:
        head = f.read(200)
    n_pts = len(v.cloud()[0])
    say("multisession", f"viewer {dtype}: {before} refreshes while the command ran (the last "
                        f"one in terminate), {len(v.points)} keyframes and {n_pts} points in "
                        f"{os.path.basename(live)} ({os.path.getsize(live)} bytes)")
    if not (before >= 1 and head.startswith("ply")):
        fail(f"the live viewer wrote no point cloud ({dtype})")
    del v
    if cli_track is not None:
        live40 = os.path.join(d, "live40.ply")
        *_, v = stage("euroc_viewer", euroc + ["--vis_path", live40])
        with_v, without = N_MAIN / track_s["euroc_viewer"], N_MAIN / cli_track
        say("multisession", f"euroc --stereo {dtype}, {N_MAIN} frames: Droid.track frames/s with "
                            f"--vis_path {with_v:.2f} ({v.refreshes} refreshes), without (the cli "
                            f"phase's euroc_stereo) {without:.2f}: the viewer costs "
                            f"{100 * (1 - with_v / without):.1f} %")
        if not (v.refreshes >= 1 and os.path.exists(live40)):
            fail(f"the live viewer of the 40-frame run wrote no point cloud ({dtype})")
        del v

    # 2. session B: A in a world frame displaced by T_known
    T_known = se3_exp(torch.tensor(T_KNOWN_XI, dtype=torch.float32))
    B = dict(A, poses=se3_mul(T_known[None], torch.from_numpy(A["poses"])).numpy())
    T_known = T_known.numpy()
    os.makedirs(os.path.join(d, "b"))
    np.savez(os.path.join(d, "b", "reconstruction.npz"), **B)
    intr = A["intrinsics"][0] * 8.0
    write_imagedir(os.path.join(d, "loop"), A["images"][:N_LOOP], intr)
    write_imagedir(os.path.join(d, "loop_rev"), A["images"][5::-1], intr)
    write_imagedir(os.path.join(d, "loop_fwd"), A["images"][:6], intr)
    write_imagedir(os.path.join(d, "all"), A["images"], intr)

    def spec(name, groups, key="groups"):
        path = os.path.join(d, name + ".json")
        with open(path, "w") as f:
            json.dump({key: groups}, f)
        return path

    def group(imagedir, frame_idx, **kw):
        return dict(imagedir=os.path.join(d, imagedir), calib=os.path.join(d, imagedir + ".txt"),
                    seed_idx=list(range(5)), frame_idx=frame_idx, **kw)

    # 3. alignment and the joint backend
    loop = list(range(5, N_LOOP))
    res, *_ = stage("align", ["multisession-align", "--first", os.path.join(a_dir, "reconstruction.npz"),
                             "--second", os.path.join(d, "b", "reconstruction.npz"),
                             "--spec", spec("align", [group("loop", loop, old_idx=loop)]),
                             "--out", os.path.join(d, "align")] + flags)
    aligned = np.load(os.path.join(d, "align", "aligned.npz"))
    T = aligned["T"]
    dot = abs(float(np.dot(T[3:7], T_known[3:7])))
    err = float(np.linalg.norm(aligned["poses"][:, :3] - A["poses"][:, :3], axis=1).mean())
    joint = np.load(os.path.join(d, "align", "aligned_joint.npz"))
    say("multisession", f"align {dtype}: T {np.round(T, 4).tolist()} against T_known "
                        f"{np.round(T_known, 4).tolist()}: |dt| {np.abs(T[:3] - T_known[:3]).max():.4f} "
                        f"(tol 1.0), |q.q_known| {dot:.6f} (> 0.9); aligned B's mean distance to A "
                        f"{err:.4f} (< 1.2, unaligned {np.linalg.norm(B['poses'][:, :3] - A['poses'][:, :3], axis=1).mean():.4f}); "
                        f"joint backend over {2 * K} keyframes: finite "
                        f"{bool(np.isfinite(joint['poses_first']).all() and np.isfinite(joint['poses_second']).all())}")
    if not (res and res[-1].get("joint") and np.abs(T[:3] - T_known[:3]).max() < 1.0
            and dot > 0.9 and err < 1.2 and np.isfinite(joint["poses_second"]).all()):
        fail(f"multisession-align did not recover T_known ({dtype})")

    # 4. the gated ImproveAdjust recovery: a shut gate rejects, an open one stitches
    shut = ["--quality_mean_thresh", "1e9", "--quality_min_thresh", "1e9"]
    res, *_ = stage("improve_shut", ["multisession-align", "--improve", "--first",
                                    os.path.join(a_dir, "reconstruction.npz"),
                                    "--spec", spec("shut", [group("loop", list(range(N_LOOP)))]),
                                    "--out", os.path.join(d, "shut")] + shut + flags)
    if not (res and res[-1]["recovered"] is False and not res[-1]["report"][0]["accepted"]
            and res[-1]["report"][0]["bad"] == N_LOOP - 5):
        fail(f"the shut gate did not reject the group ({dtype}): {res}")
    open_gate = ["--quality_mean_thresh", "-1", "--quality_min_thresh", "-1"]
    res, *_ = stage("improve", ["multisession-align", "--improve", "--first",
                               os.path.join(a_dir, "reconstruction.npz"),
                               "--spec", spec("open", [group("loop_rev", [5, 4, 3, 2, 1, 0], name="rev"),
                                                       group("loop_fwd", list(range(6)), name="fwd")]),
                               "--out", os.path.join(d, "open")] + open_gate + flags)
    rec = os.path.join(d, "open", "recovered.npz")
    if not (res and res[-1]["recovered"] and os.path.exists(rec)
            and [r["forward"] for r in res[-1]["report"]] == [False, True]
            and np.isfinite(np.load(rec)["poses"]).all()):
        fail(f"the open gate did not recover a stitched map ({dtype}): {res}")

    # 5. fusion of A and the aligned B
    sessions = os.path.join(d, "sessions")
    os.makedirs(os.path.join(sessions, "b"))
    os.symlink(a_dir, os.path.join(sessions, "a"))
    np.savez(os.path.join(sessions, "b", "reconstruction.npz"), **dict(B, poses=aligned["poses"]))
    stage("fuse", ["multisession", "--sessions", sessions, "--subsample", "2",
                   "--out", os.path.join(d, "fused")] + flags)
    fused_path = os.path.join(d, "fused", "fused.npz")
    fused = np.load(fused_path)
    n_fused = len(fused["poses"])
    say("multisession", f"fuse {dtype}: the fused map holds {n_fused} keyframes "
                        f"({K} + {K} subsampled by 2), finite {bool(np.isfinite(fused['poses']).all())}")
    if not (n_fused == 2 * ((K + 1) // 2) and np.isfinite(fused["poses"]).all()):
        fail(f"multisession fused {n_fused} keyframes ({dtype})")

    # 6. evaluation: one sequence per session, against a ground truth
    gt = os.path.join(d, "gt.txt")
    np.savetxt(gt, np.array([[t, 0.05 * t, 0.01 * t, 0, 0, 0, 0, 1] for t in range(K)], float))
    half = n_fused // 2
    seqs = [dict(imagedir=os.path.join(d, "all"), calib=os.path.join(d, "all.txt"), gt=gt,
                 start=a, stop=b) for a, b in ((0, half), (half, n_fused))]
    res, *_ = stage("evaluate", ["multisession-evaluate", "--fused", fused_path,
                                "--spec", spec("eval", seqs, "sequences"),
                                "--out", os.path.join(d, "trajs")] + flags)
    trajs = [np.load(os.path.join(d, "trajs", f"traj_{i}.npy")) for i in range(2)]
    if not (res and res[-1]["sequences"] == 2 and np.isfinite(res[-1]["ate"]["rmse"])
            and all(tr.shape == (K, 7) and np.isfinite(tr).all() for tr in trajs)):
        fail(f"multisession-evaluate gave no finite ATE or trajectories ({dtype}): {res}")

    # 7. the point cloud of the three maps, one hue each
    cloud = os.path.join(d, "cloud.ply")
    _, lines, _ = stage("view", ["view", "--reconstruction", os.path.join(a_dir, "reconstruction.npz"),
                              os.path.join(d, "b", "reconstruction.npz"), fused_path,
                              "--color_by_session", "--out", cloud])
    with open(cloud) as f:
        head = f.read(300)
    if not (head.startswith("ply") and len(lines) == 4 and "property uchar red" in head):
        fail(f"view wrote no colored cloud ({dtype}): {lines}")
    return by_path, A


def phase_probe_spread(torch, A):
    """The gated frontend's probe in bf16 against fp32 on one state at full
    width: a bf16 loop session (A's first N_LOOP keyframes, 5 seeds) leaves
    its frontend graph; an fp32 SDroid loads the same video (the bf16
    features, exactly) and the graph's edges, hidden states and targets;
    both probe.  Prints the spread of the summed confidences and whether
    the default gate (mean > 200, each > 10) decides alike on the newest
    keyframe's edges.  The decision is not held: 8 significant bits move a
    sum near a threshold."""
    from droid_slam_reserch_tpu_torch.engine import SDroid
    from droid_slam_reserch_tpu_torch.multisession import run_loop_session
    from droid_slam_reserch_tpu_torch.utils import EUROC_CONFIG

    cfg = EUROC_CONFIG.replace(stereo=True, compute_dtype="bfloat16")
    intr = A["intrinsics"][0] * 8.0
    stream = [(float(t), img, intr) for t, img in enumerate(A["images"][:N_LOOP])]
    d16 = run_loop_session(cfg, None, A["poses"][:5], A["disps"][:5], stream, device="cuda")
    g16 = d16.frontend.graph
    d32 = SDroid(cfg.replace(compute_dtype="float32"), device="cuda")
    d32.video.load_state_dict(d16.video.state_dict())
    g32 = d32.frontend.graph
    g32.ii, g32.jj, g32.age = g16.ii.copy(), g16.jj.copy(), g16.age.copy()
    g32.net, g32.target, g32.weight = g16.net.float(), g16.target.clone(), g16.weight.clone()
    s16, s32 = g16.probe_quality(), g32.probe_quality()
    rel = np.abs(s16 - s32) / np.maximum(np.abs(s32), 1e-6)
    newest = d16.video.counter - 1
    sel = [k for k, (i, j) in enumerate(zip(g16.ii, g16.jj))
           if (i == newest and newest - 3 < j != i) or (j == newest and newest - 3 < i != j)]

    def gate(s):
        v = s[sel]
        return bool(len(v) and v.mean() > cfg.quality_mean_thresh
                    and (v > cfg.quality_min_thresh).all())
    say("multisession", f"probe bf16 against fp32 on one state ({cfg.image_size[0]}x"
                        f"{cfg.image_size[1]} stereo, {len(s32)} edges): "
                        f"summed in [{s32.min():.2f}, {s32.max():.2f}] (fp32), |bf16 - fp32| max "
                        f"{np.abs(s16 - s32).max():.4f}, relative max {rel.max():.3e}, median "
                        f"{np.median(rel):.3e}; the default gate on the newest keyframe's "
                        f"{len(sel)} edges: bf16 {gate(s16)}, fp32 {gate(s32)}")
    if not (np.isfinite(s16).all() and np.isfinite(s32).all() and len(s32) > 0):
        fail("the probe's summed confidence is not finite")


def phase_multisession_card_vs_cpu(torch, dtype):
    """joint_backend and fuse_maps at 64x96 (stereo, small_config) on the card
    against the port's CPU run from the same states: an N_SMALL-frame stereo
    session tracked on the card, and the same session displaced by an SE3
    and aligned back.  Poses within 1e-3 in fp32, 2e-2 in bf16 (as the
    card-vs-CPU phase)."""
    from droid_slam_reserch_tpu_torch.engine import Droid
    from droid_slam_reserch_tpu_torch.lie import se3_exp, se3_mul
    from droid_slam_reserch_tpu_torch.models import init_params
    from droid_slam_reserch_tpu_torch.multisession import fuse_maps, joint_backend, transform_poses
    from droid_slam_reserch_tpu_torch.utils import DroidConfig

    params = init_params(seed=0)
    intr = np.array([60.0, 60.0, 48.0, 32.0], np.float32)
    cfg = small_config(DroidConfig).replace(compute_dtype=dtype, stereo=True)
    droid = Droid(cfg, params=params, device="cuda")
    for t, (img, _) in enumerate(small_frames("stereo")):
        droid.track(float(t), img, intrinsics=intr)
    A = droid.video.state_dict()
    del droid
    T = se3_exp(torch.tensor([0.5, -0.2, 0.1, 0.05, -0.1, 0.08]))
    B = dict(A, poses=transform_poses(T.numpy(), se3_mul(T[None], torch.from_numpy(A["poses"])).numpy()))
    tol = 2e-2 if dtype == "bfloat16" else 1e-3
    for name, fn in (("joint_backend", lambda dev: np.concatenate(joint_backend(cfg, params, [A, B], device=dev))),
                     ("fuse_maps", lambda dev: fuse_maps(cfg, params, [A, B], device=dev)["poses"])):
        gpu, cpu = fn("cuda"), fn("cpu")
        diff = float(np.abs(gpu - cpu).max()) if gpu.shape == cpu.shape else float("inf")
        say("card-vs-cpu", f"{dtype} multisession {name} 64x96 stereo over {len(A['poses'])} + "
                           f"{len(B['poses'])} keyframes: poses {gpu.shape}, max |diff| "
                           f"{diff:.3e} (tol {tol:.0e})")
        if not (np.isfinite(gpu).all() and diff <= tol):
            fail(f"the card's {name} and the CPU's disagree ({dtype})")


# ------------------------------------------------------------------ training
#
# TrainConfig's defaults: a 384x512 crop, 7 frames, 15 unrolled iterations of
# 2 BA steps, a graph of up to 24 covisibility edges (or the radius-2 temporal
# graph) padded to 28 edges, batch 1, DroidNet at full width, seeded weights.
TRAIN_H, TRAIN_W, TRAIN_P, TRAIN_IT, TRAIN_E_PAD = 384, 512, 7, 15, 28
# the fnet's conv biases in front of an instance norm: their gradient is 0 in
# exact arithmetic, so any two runs differ by rounding noise alone
TRAIN_ZERO_GRAD = tuple(f"fnet.{n}.bias" for n in (
    "conv1", "layer1.0.conv1", "layer1.0.conv2", "layer1.1.conv1", "layer1.1.conv2",
    "layer2.0.conv1", "layer2.0.conv2", "layer2.0.downsample.0", "layer2.1.conv1",
    "layer2.1.conv2", "layer3.0.conv1", "layer3.0.conv2", "layer3.0.downsample.0",
    "layer3.1.conv1", "layer3.1.conv2"))


def train_scene(rng, n_frames, H, W):
    """A geometrically consistent synthetic training item (the JAX package's
    tools/bench_train.py synth_scene): small forward steps and rotations over
    a blocky depth field of 4 to 12 m, band-limited texture; poses
    world-to-camera, disps inverse depth, intrinsics at full resolution."""
    fx = fy = 0.6 * W
    intrinsics = np.broadcast_to(np.array([fx, fy, W / 2.0, H / 2.0], np.float32), (n_frames, 4))
    poses = np.zeros((n_frames, 7), np.float32)
    poses[:, 6] = 1.0
    for t in range(n_frames):
        poses[t, 0] = 0.04 * t + 0.01 * rng.standard_normal()
        poses[t, 2] = 0.10 * t
        poses[t, 3:6] = 0.01 * rng.standard_normal(3)
        q = np.concatenate([poses[t, 3:6], [1.0]])
        poses[t, 3:] = q / np.linalg.norm(q)
    base = rng.uniform(0.5, 1.0, (n_frames, H // 32, W // 32)).astype(np.float32)
    depth = 4.0 + 8.0 * np.kron(base, np.ones((32, 32), np.float32))[:, :H, :W]
    imgs = rng.uniform(0, 255, (n_frames, H // 8, W // 8, 3)).astype(np.float32)
    images = np.kron(imgs, np.ones((8, 8, 1), np.float32))[:, :H, :W]
    return images, poses, (1.0 / depth).astype(np.float32), np.ascontiguousarray(intrinsics)


def train_batch(torch, item, graph, device):
    """The dynamic step's batch from a numpy item (images, poses, disps,
    intrinsics) and a sampled graph (ii, jj, emask), on `device`."""
    from droid_slam_reserch_tpu_torch.lie import se3_inv
    from droid_slam_reserch_tpu_torch.train.step import initial_poses

    images, poses, disps, intr = (torch.from_numpy(np.ascontiguousarray(x[None])).to(device)
                                  for x in item)
    ii, jj, em = graph
    return {"images": images, "poses": poses, "disps": disps, "intrinsics": intr,
            "ii": torch.from_numpy(ii).long().to(device),
            "jj": torch.from_numpy(jj).long().to(device),
            "emask": torch.from_numpy(em).to(device), "Gs0": initial_poses(se3_inv(poses)),
            "disp0": torch.ones_like(disps[:, :, 3::8, 3::8])}


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def relu_masks(torch):
    """A torch function mode that records the sign mask of every ReLU input
    (F.relu, torch.relu) of a run in order, or, given a run's masks, replays
    them: each ReLU passes its input where the recorded run's input was
    positive, so the forward moves by at most the flipped inputs and the
    backward takes the recorded run's mask.  `flips` counts the entries whose
    own sign differs from the recorded one, `near` their largest |input|."""
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    class ReluMasks(TorchFunctionMode):
        def __init__(self, masks=None):
            super().__init__()
            self.replay, self.masks = masks is not None, [] if masks is None else masks
            self.calls, self.flips, self.near = 0, 0, 0.0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func not in (F.relu, torch.relu, torch.Tensor.relu):
                return func(*args, **kwargs)
            x = args[0]
            if not self.replay:
                self.masks.append(x.detach() > 0)
                return func(*args, **kwargs)
            m = self.masks[self.calls].to(x.device)
            self.calls += 1
            d = (x.detach() > 0) != m
            if d.any():
                self.flips += int(d.sum())
                self.near = max(self.near, float(x.detach()[d].abs().max()))
            return torch.where(m, x, torch.zeros_like(x))

    return ReluMasks


def train_card_vs_cpu(torch):
    """(a) One make_train_step_dynamic step at 64x64, P = 4, 2 iterations on
    the card against device="cpu".

    fp32: loss, metrics and carry within 1e-3 relative, every gradient
    within 1e-3 relative L2, the fnet biases of TRAIN_ZERO_GRAD (zero in
    exact arithmetic) under 1e-6, with the CPU's ReLU masks replayed on the
    card (relu_masks).  The gradient is piecewise smooth: a ReLU input that
    crosses 0 moves it by a fixed amount, and at this size, where the fnet's
    last layers are 8x8 maps, one entry's flip moves a weight's gradient by
    up to 1e-2 relative.  Here layer3.1.conv1's ReLU input at frame 0,
    channel 53, (5, 2) lies 1.2e-6 from 0; the card's rounding, or any 3e-7
    move of the weights, flips it, and that weight's gradient moves by
    4.45e-3.  With the masks replayed the CPU's own gradient under such
    moves stays within 4e-5 (1 to 7 flips of |input| up to 9e-6), so the
    replay removes the flips and nothing else: the card's flips must lie
    within 1e-4 of 0.  The card's gradients without the replay are printed
    beside, unchecked.

    Then two apply_steps on each device from the same gradients (the
    CPU's, then the card's): the new parameters within 1e-6 relative (1e-9
    absolute), far under the steps' own size, which depends on the
    gradients' sizes from the second step on.

    bf16 (no replay: the flips are many at bf16's rounding): loss within
    1e-3 relative, metrics within 5e-3, carry within 2e-3, all gradients
    together within 0.15 relative L2, the limits of
    tests/test_torch_train_bf16.py, which holds the CPU's bf16 step against
    the JAX package's."""
    from droid_slam_reserch_tpu_torch.models import init_params
    from droid_slam_reserch_tpu_torch.train import TrainConfig
    from droid_slam_reserch_tpu_torch.train.step import (init_opt_state, make_schedule,
                                                         make_train_step_dynamic,
                                                         sample_frame_graph)

    P, H, W = 4, 64, 64
    cfg = TrainConfig(batch=1, n_frames=P, iters=2, steps=10)
    item = train_scene(np.random.default_rng(1), P, H, W)
    graph = sample_frame_graph(np.random.default_rng(0), *(x[None] for x in item[1:]), P, 16)
    start = init_params(0)
    apply_step = make_train_step_dynamic(cfg)[1]
    ReluMasks = relu_masks(torch)

    def step_on(dev, dtype=None, mode=None):
        grad_step = make_train_step_dynamic(cfg, dtype=dtype)[0]
        with mode or contextlib.nullcontext():
            g, m, c = grad_step({k: v.to(dev) for k, v in start.items()},
                                train_batch(torch, item, graph, dev))
        return ({k: v.cpu() for k, v in g.items()}, {k: float(v) for k, v in m.items()},
                [x.float().cpu() for x in c])

    def worst_rel(a, b):
        return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6) for k in b)

    record = ReluMasks()
    g0, m0, c0 = step_on("cpu", mode=record)
    replay = ReluMasks(record.masks)
    g1, m1, c1 = step_on("cuda", mode=replay)
    g_free = step_on("cuda")[0]
    names = [k for k in g0 if k not in TRAIN_ZERO_GRAD]
    worst_m = worst_rel(m1, m0)
    worst_c = max(float((a - b).abs().max()) for a, b in zip(c1, c0))
    rel = {k: _rel_l2(g1[k], g0[k]) for k in names}
    worst_g = max(rel, key=rel.get)
    free = {k: _rel_l2(g_free[k], g0[k]) for k in names}
    worst_free = max(free, key=free.get)
    noise = max(float(g1[k].norm()) + float(g0[k].norm()) for k in TRAIN_ZERO_GRAD)

    new = {}
    for dev in ("cuda", "cpu"):
        params = {k: v.to(dev) for k, v in start.items()}
        state = init_opt_state(params)
        for g in (g0, g1):
            params, state = apply_step(params, state, {k: v.to(dev) for k, v in g.items()})
        new[dev] = {k: v.cpu() for k, v in params.items()}
    p_ok = all(torch.allclose(new["cuda"][k], new["cpu"][k], rtol=1e-6, atol=1e-9) for k in start)
    p_err = max(float((new["cuda"][k] - new["cpu"][k]).abs().max()) for k in start)
    p_move = max(float((new["cpu"][k] - start[k]).abs().max()) for k in start)
    lrs = [make_schedule(cfg)(i) for i in range(2)]

    gb1, mb1, cb1 = step_on("cuda", torch.bfloat16)
    gb0, mb0, cb0 = step_on("cpu", torch.bfloat16)
    loss_b = abs(mb1["loss"] - mb0["loss"]) / abs(mb0["loss"])
    worst_mb = worst_rel(mb1, mb0)
    worst_cb = max(float((a - b).abs().max()) for a, b in zip(cb1, cb0))
    rel_b = _rel_l2(torch.cat([gb1[k].ravel() for k in names]),
                    torch.cat([gb0[k].ravel() for k in names]))
    say("train", f"card vs CPU, one dynamic step at 64x64, P=4, 2 iterations, "
                 f"{int(graph[2].sum())} of 16 edges; fp32 with the CPU's masks of "
                 f"{len(record.masks)} ReLU calls replayed ({replay.flips} inputs flipped, "
                 f"|input| up to {replay.near:.1e}, tol 1e-4): loss {m1['loss']:.6f} against "
                 f"{m0['loss']:.6f}, metrics within {worst_m:.2e} relative (tol 1e-3), carry "
                 f"{worst_c:.2e} (tol 1e-3), gradients worst {worst_g} {rel[worst_g]:.2e} "
                 f"relative L2 (tol 1e-3); without the replay worst {worst_free} "
                 f"{free[worst_free]:.2e}, {sum(r > 1e-3 for r in free.values())} of {len(names)} "
                 f"over 1e-3 (unchecked); zero-in-exact-arithmetic biases {noise:.1e} (tol 1e-6); "
                 f"params after two apply_steps from the same gradients within {p_err:.2e} (tol "
                 f"1e-6 relative, 1e-9 absolute; the steps moved them by up to {p_move:.2e}, lr "
                 f"{lrs[0]:.1e} then {lrs[1]:.1e})")
    say("train", f"card vs CPU in bf16: loss {mb1['loss']:.6f} against {mb0['loss']:.6f} "
                 f"({loss_b:.2e} relative, tol 1e-3), metrics within {worst_mb:.2e} (tol 5e-3), "
                 f"carry {worst_cb:.2e} (tol 2e-3), all gradients {rel_b:.3f} relative L2 (tol "
                 f"0.15); the card's bf16 loss against its fp32 one "
                 f"{abs(mb1['loss'] - m1['loss']) / abs(m1['loss']):.2e} relative")
    if replay.calls != len(record.masks) or replay.near >= 1e-4:
        fail("the card's ReLU calls or signs differ from the CPU's beyond rounding")
    if not (worst_m < 1e-3 and worst_c < 1e-3 and rel[worst_g] <= 1e-3 and noise < 1e-6
            and p_ok):
        fail("the card's training step and the CPU's disagree")
    if not (loss_b < 1e-3 and worst_mb < 5e-3 and worst_cb < 2e-3 and rel_b < 0.15):
        fail("the card's bf16 training step and the CPU's disagree")


def train_lookup_time(torch, E, h, w):
    """The training lookup (ops/corr.py corr_lookup_pyramid under autograd,
    the plain gather, no kernel) at the full shape: forward alone and
    forward + backward, CUDA events; and the bytes it must move at least
    (the pyramid read once, the lookups written once; backward: the lookups'
    gradient read once, the pyramid's gradient written once)."""
    from droid_slam_reserch_tpu_torch.ops.corr import (build_pyramid, corr_lookup_pyramid,
                                                       corr_volume)

    g = torch.Generator(device="cuda").manual_seed(0)
    f1 = torch.randn(E, h, w, 128, device="cuda", generator=g)
    f2 = torch.randn(E, h, w, 128, device="cuda", generator=g)
    pyr = [v.detach().requires_grad_(True) for v in build_pyramid(corr_volume(f1, f2))]
    coords = (torch.rand(E, h, w, 2, device="cuda", generator=g)
              * torch.tensor([w, h], device="cuda", dtype=torch.float32))
    gout = torch.randn(E, h, w, 196, device="cuda", generator=g)

    def fwd():
        return corr_lookup_pyramid(pyr, coords)

    def fwd_bwd():
        torch.autograd.grad(corr_lookup_pyramid(pyr, coords), pyr, gout)

    ms_f, ms_fb = cuda_ms(torch, fwd, 10), cuda_ms(torch, fwd_bwd, 10)
    vol_bytes = sum(v.numel() for v in pyr) * 4
    out_bytes = E * h * w * 196 * 4 + E * h * w * 2 * 4
    b_f = bound(0, vol_bytes + out_bytes)[0]
    b_fb = bound(0, 2 * vol_bytes + 2 * out_bytes)[0]
    say("train", f"training lookup (plain gather under autograd, {E} edges x {h}x{w}, 4 levels, "
                 f"fp32 pyramid {vol_bytes / 2**30:.2f} GiB): forward {ms_f:.3f} ms (bound "
                 f"{b_f:.3f} ms, bytes), forward + backward {ms_fb:.3f} ms (bound {b_fb:.3f} ms)")
    return {"forward_ms": ms_f, "forward_backward_ms": ms_fb, "bound_forward_ms": b_f,
            "bound_forward_backward_ms": b_fb}


def train_profile(torch, step_fn):
    """One full-width step under torch.profiler (device activity only, to
    keep the trace of some 190,000 kernels cheap): the device's busy share,
    from the union of its kernels' intervals (cuDNN runs some on streams of
    its own, so their sum can exceed the wall), and the top device kernels;
    the table goes to chiprun_out/profile_train.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -np.inf
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    dev = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                 reverse=True)
    if busy == 0:
        fail("torch.profiler recorded no device time in the training step")
    total = sum(us for us, _, _ in dev)
    say("train", f"profiled fp32 step (no remat): wall {wall_us / 1e3:.1f} ms, device busy "
                 f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f} %), idle "
                 f"{100 * (1 - busy / wall_us):.1f} %; kernel time {total / 1e3:.1f} ms over "
                 f"{len(spans)} kernels")
    say("train", "top device kernels (ms, launches): " + "; ".join(
        f"{name[:70]} {us / 1e3:.1f} {n}" for us, n, name in dev[:10]))
    with open(os.path.join(OUT_DIR, "profile_train.txt"), "w") as f:
        f.write(f"one training step: wall {wall_us:.0f} us, device busy {busy:.0f} us, "
                f"kernel time {total:.0f} us\n\n")
        for us, n, name in dev:
            f.write(f"{us:12.1f} {n:7d}  {name[:160]}\n")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3, "idle_share": 1 - busy / wall_us,
            "kernel_ms": total / 1e3, "kernels": len(spans),
            "top": [(name, us / 1e3, n) for us, n, name in dev[:10]]}


def train_full_shape(torch):
    """(b) At TrainConfig's full shape, on a synthetic scene with a graph
    from sample_frame_graph: 3 optimizer steps in fp32 with remat, 3
    without, 3 in bf16 (the first of each mode warms up); each step's
    seconds (host clock, synchronised) split into forward, backward and
    optimizer, the peak memory, finite losses.  Then one fp32 step under
    torch.profiler."""
    from droid_slam_reserch_tpu_torch.train import TrainConfig
    from droid_slam_reserch_tpu_torch.train.step import (init_train_state, make_optimizer,
                                                         sample_frame_graph, sampled_graph_loss)

    cfg = TrainConfig()
    item = train_scene(np.random.default_rng(0), TRAIN_P, TRAIN_H, TRAIN_W)
    graph = sample_frame_graph(np.random.default_rng(2), *(x[None] for x in item[1:]), TRAIN_P,
                               TRAIN_E_PAD, device="cuda")
    batch = train_batch(torch, item, graph, "cuda")
    opt = make_optimizer(cfg)
    say("train", f"full shape: {TRAIN_H}x{TRAIN_W}, {TRAIN_P} frames, {TRAIN_IT} iterations x 2 "
                 f"BA steps, {int(graph[2].sum())} edges padded to {TRAIN_E_PAD}, batch 1")
    results = {}
    for mode, dtype, remat, n in (("fp32 remat", None, True, 3), ("fp32", None, False, 3),
                                  ("bf16", torch.bfloat16, False, 3)):
        loss_fn = sampled_graph_loss(cfg, dtype=dtype, remat=remat)
        params, state = init_train_state(cfg, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rows, losses = [], []
        for _ in range(n):
            leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, (metrics, _) = loss_fn(leaves, batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            params, state = opt(params, state, grads)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            rows.append((t3 - t0, t1 - t0, t2 - t1, t3 - t2))
            losses.append(float(loss.detach()))
            del leaves, loss, grads
        peak = torch.cuda.max_memory_allocated() / 2**30
        steady = np.median(rows[1:], axis=0)
        say("train", f"{mode}: s per step (total / forward / backward / optimizer) "
                     + ", ".join("/".join(f"{x:.3f}" for x in r) for r in rows)
                     + f"; median after the first {steady[0]:.3f} s; peak memory {peak:.2f} GiB; "
                     f"losses {', '.join(f'{x:.4f}' for x in losses)}")
        if not np.isfinite(losses).all() or not all(
                bool(torch.isfinite(p).all()) for p in params.values()):
            fail(f"training at the full shape ({mode}) gave a non-finite loss or parameter")
        results[mode] = {"s_per_step": steady[0], "forward_s": steady[1], "backward_s": steady[2],
                         "optimizer_s": steady[3], "steps": rows, "peak_gib": peak,
                         "losses": losses}
        if mode == "fp32":
            def one_step():
                leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
                loss, _ = loss_fn(leaves, batch)
                torch.autograd.grad(loss, list(leaves.values()))

            results["profile"] = train_profile(torch, one_step)
        del params, state, loss_fn
    say("train", f"full shape: remat costs {results['fp32 remat']['s_per_step'] / results['fp32']['s_per_step']:.2f}x "
                 f"the time and saves {results['fp32']['peak_gib'] - results['fp32 remat']['peak_gib']:.2f} GiB; "
                 f"bf16 takes {results['bf16']['s_per_step'] / results['fp32']['s_per_step']:.2f}x fp32's time")
    E, h, w = TRAIN_E_PAD, TRAIN_H // 8, TRAIN_W // 8
    results["lookup"] = train_lookup_time(torch, E, h, w)
    return results


def train_overfit(torch):
    """(c) 8 make_train_step steps on one fixed scene at 192x256, 7 frames,
    4 iterations, the temporal graph, fp32 (the OneCycle horizon of
    TrainConfig's 250000 steps): the last loss must be below the first."""
    from droid_slam_reserch_tpu_torch.train import TrainConfig
    from droid_slam_reserch_tpu_torch.train.step import (init_train_state, make_train_step,
                                                         temporal_graph)

    H, W, IT = 192, 256, 4
    cfg = TrainConfig(iters=IT, image_size=(H, W))
    ii, jj = (torch.from_numpy(x).long().cuda() for x in temporal_graph(TRAIN_P))
    item = train_scene(np.random.default_rng(0), TRAIN_P, H, W)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[None])).cuda()
             for k, v in zip(("images", "poses", "disps", "intrinsics"), item)}
    params, state = init_train_state(cfg, device="cuda")
    step = make_train_step(cfg, ii, jj, num_steps=IT)
    losses = []
    t0 = time.perf_counter()
    for _ in range(8):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    say("train", f"overfit, 8 steps at {H}x{W}, {IT} iterations in {time.perf_counter() - t0:.1f} "
                 f"s: losses {', '.join(f'{x:.4f}' for x in losses)}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail("the overfit loss did not fall")


def write_tartan_training_scene(root, n=16, H=480, W=640):
    """A TartanAir training scene, root/env/env/Easy/P001: n 480x640 PNGs of
    euroc_frames' texture, depth_left .npy of 2 m plus a ripple, NED poses
    0.1 m apart (0.02 after the dataset's depth scale: about 16 px of flow)."""
    scene = os.path.join(root, "env", "env", "Easy", "P001")
    os.makedirs(os.path.join(scene, "image_left"))
    os.makedirs(os.path.join(scene, "depth_left"))
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    depth = (2.0 + 0.2 * np.sin(0.01 * xs) * np.cos(0.01 * ys)).astype(np.float32)
    for t, img in enumerate(euroc_frames(n, seed=7, H=H, W=W)):
        write_png(os.path.join(scene, "image_left", f"{t:06d}_left.png"), img)
        np.save(os.path.join(scene, "depth_left", f"{t:06d}_left_depth.npy"), depth)
    np.savetxt(os.path.join(scene, "pose_left.txt"),
               np.asarray([[0.0, 0.1 * t, 0.0, 0.0, 0.0, 0.0, 1.0] for t in range(n)]))
    return scene


def train_cli(torch, ops, root):
    """(d) cli.main(["train", ...]) at the full crop (TrainConfig's defaults,
    restarts at 0.2) on a TartanAir scene of 480x640 PNGs: 2 steps with a
    checkpoint each, then a resume to 3 (the optimizer state carried); then
    the port's tartanair command with --weights at that checkpoint.  Returns
    the training commands' counts; the tracking's are checked apart."""
    import contextlib
    import io

    from droid_slam_reserch_tpu_torch import cli
    from droid_slam_reserch_tpu_torch.train import load_ckpt

    scene = write_tartan_training_scene(os.path.join(root, "tartan_train"))
    cwd = os.getcwd()
    os.chdir(root)                                   # checkpoints/ and runs/ land here
    try:
        argv = ["train", "--datapath", os.path.join(root, "tartan_train"), "--save_every", "1",
                "--name", "smoke"]
        ops.reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(argv + ["--steps", "2"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(argv + ["--steps", "3", "--ckpt", "checkpoints/smoke_000002.npz"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = ops.counts()
        ck = os.path.join(root, "checkpoints", "smoke_000003.npz")
        params, state, step = load_ckpt(ck)
        if not (step == 3 and state is not None and state["count"] == 3
                and all(bool(torch.isfinite(p).all()) for p in params.values())):
            fail("cli train: the resumed checkpoint is not at step 3 with finite parameters")
        say("train", f"cli train at {TRAIN_H}x{TRAIN_W}, 7 frames, 15 iterations: 2 steps in "
                     f"{t1 - t0:.1f} s (the dataset's index included), resume to 3 in "
                     f"{t2 - t1:.1f} s; checkpoint step {step}, Adam count {state['count']}")
        ops.reset_counts()
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            droid = cli.main(["tartanair", "--datapath", scene, "--gt", scene + "/pose_left.txt",
                              "--weights", ck, "--filter_thresh", "-1", "--keyframe_thresh", "0"])
        torch.cuda.synchronize()
        res = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
        ate = res[-1]["ate_score"] if res else float("nan")
        say("train", f"tartanair with --weights {os.path.basename(ck)}: {droid.video.counter} "
                     f"keyframes in {time.perf_counter() - t0:.1f} s, ate_score {ate:.4f}; "
                     f"counts {ops.counts()}")
        if not np.isfinite(ate):
            fail("tartanair with the trained weights printed no finite ate_score")
        check_counts(ops.counts(), "tartanair with the trained weights", MAIN_KERNELS, OFF_ENGINE)
        del droid
    finally:
        os.chdir(cwd)
    return counts


def phase_train(torch, ops):
    """The training path (see train_card_vs_cpu, train_full_shape,
    train_overfit and train_cli).  Around (b) to (d) every kernel's launch
    count and every plain version's call count is set to 0 and read back as
    0: training runs plain PyTorch under autograd and calls no kernel
    wrapper.  Returns the counts and the full shape's numbers."""
    t0 = time.time()
    train_card_vs_cpu(torch)
    say("time", f"train (a) card vs CPU: {time.time() - t0:.1f} s")
    ops.reset_counts()
    t0 = time.time()
    results = train_full_shape(torch)
    say("time", f"train (b) full shape: {time.time() - t0:.1f} s")
    t0 = time.time()
    train_overfit(torch)
    say("time", f"train (c) overfit: {time.time() - t0:.1f} s")
    counts = ops.counts()
    root = tempfile.mkdtemp(prefix="droid_train_")
    try:
        t0 = time.time()
        counts_cli = train_cli(torch, ops, root)
        say("time", f"train (d) cli: {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for what, c in (("training at the full shape and the overfit", counts),
                    ("the cli's train", counts_cli)):
        if any(launches or plain for launches, plain in c.values()):
            fail(f"{what} called a kernel or a plain version: {c}")
    say("train", "no kernel and no plain version ran in (b)-(d)'s training")
    torch.cuda.empty_cache()
    return {k: (counts[k][0] + counts_cli[k][0], counts[k][1] + counts_cli[k][1])
            for k in counts}, results


# ------------------------------------------------------------------ parallel

MW_SHARDED = 128        # the sharded BA's window: the auto rule's smallest (MW >= 128)
BA_ROUNDS = 25          # interleaved timing rounds of the sharded BA configurations
# sharded against unsharded terminate_eva on the bf16 mono main path's state: the
# backend's BA sums by atomic scatter-adds on the card (an unsharded rerun moves the
# trajectory by about 1e-5) and the sharded BA in another order; 1e-3 is the fp32
# card-vs-CPU limit, two orders above both
SHARDED_TOL = 1e-3


def sharded_ba_problem(torch, MW=MW_SHARDED, seed=5):
    """A global BA at the main path's 40x64: MW frames panning along x with
    small rotations, a radius-2 temporal graph (both directions) plus 16
    long edges 8-24 frames apart, targets the true reprojections plus 0.5
    px of noise, weights in [0.5, 1) where the reprojection is valid; the
    poses moved off by 0.01 and the disparities by 5 %.  Returns the
    window's tensors on the card and the host edge lists."""
    from droid_slam_reserch_tpu_torch.geom import neighbourhood_graph, projective_transform
    from droid_slam_reserch_tpu_torch.lie import se3_exp, se3_retr

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.RandomState(seed)
    xi = torch.cat([0.05 * torch.arange(MW, device=dev)[:, None]
                    * torch.tensor([1.0, 0.1, 0.0], device=dev),
                    0.01 * torch.randn(MW, 3, generator=gen, device=dev)], 1)
    poses_gt = se3_exp(xi)
    disps = 0.5 + torch.rand(MW, H8, W8, generator=gen, device=dev)
    intr = torch.tensor(INTR_EUROC / 8.0, device=dev)
    ii, jj = (np.asarray(x, np.int64) for x in neighbourhood_graph(MW, 2))
    li = rng.randint(0, MW - 24, 8)
    lj = li + rng.randint(8, 25, 8)
    ii, jj = np.concatenate([ii, li, lj]), np.concatenate([jj, lj, li])
    iit, jjt = torch.as_tensor(ii, device=dev), torch.as_tensor(jj, device=dev)
    target, valid = projective_transform(poses_gt[None], disps[None], intr.expand(MW, 4)[None],
                                         iit, jjt)
    target = (target[0] + 0.5 * torch.randn(target.shape[1:], generator=gen,
                                            device=dev)).contiguous()
    weight = ((0.5 + 0.5 * torch.rand(target.shape, generator=gen, device=dev))
              * valid[0]).contiguous()
    dxi = 0.01 * torch.randn(MW, 6, generator=gen, device=dev)
    dxi[0] = 0.0
    poses0 = se3_retr(poses_gt, dxi).contiguous()
    eta = torch.full((MW, H8, W8), 1e-4, device=dev)
    free = torch.arange(MW, device=dev) >= 1
    return (poses0, (1.05 * disps).contiguous(), intr, torch.zeros_like(disps), target, weight,
            eta, free), ii, jj


def parallel_ba(torch, ops):
    """dist_ba_solve at S = 2 and 4 shards, all on cuda:0, in both
    exchanges, against the unsharded ba_iterations on the same inputs:
    poses within 5e-4 and disparities within 5e-3 (tests/test_parallel.py's
    limits); K1 launches S x 2 per call (2 iterations) and is held against
    its plain version on shard 0's inputs.  Every configuration is timed
    beside the unsharded solve by CUDA events around whole calls (host work
    included), BA_ROUNDS rounds that call each configuration once in turn,
    so that a drift of the card's clock reaches every configuration alike;
    the median and the quartiles of each are kept.  partition_edges and the
    bucket tables are timed on the host clock.  Returns the counts of the
    untimed calls and the times."""
    from droid_slam_reserch_tpu_torch import native
    from droid_slam_reserch_tpu_torch.ba.solver import ba_iterations
    from droid_slam_reserch_tpu_torch.parallel import dist_ba_solve, make_mesh, partition_edges
    from droid_slam_reserch_tpu_torch.parallel.dist_ba import CUDA_EXCHANGE

    (poses0, disps0, intr, dsens, target, weight, eta, free), ii, jj = sharded_ba_problem(torch)
    MW = poses0.shape[0]
    dev = poses0.device
    t0 = time.perf_counter()
    be, bm = native.bucket_tables(ii, MW)
    tables_ms = 1e3 * (time.perf_counter() - t0)
    iit, jjt = torch.as_tensor(ii, device=dev), torch.as_tensor(jj, device=dev)
    bet, bmt = torch.as_tensor(be, dtype=torch.int64, device=dev), torch.as_tensor(bm, device=dev)

    def single():
        return ba_iterations(poses0, disps0, intr, dsens, target, weight, eta, iit, jjt, free,
                             bet, bmt, iterations=2, min_depth=0.25)

    ops.reset_counts()
    p1, d1 = single()
    torch.cuda.synchronize()
    if ops.counts()["ba_blocks"] != (2, 0):
        fail(f"the unsharded solve did not launch K1 twice: {ops.counts()['ba_blocks']}")
    moved = float((p1 - poses0).abs().max())
    say("parallel", f"sharded BA: MW={MW}, {len(ii)} edges at {H8}x{W8} (radius-2 graph + 16 "
                    f"long edges), 2 iterations; bucket tables {tables_ms:.2f} ms on the host; "
                    f"poses moved {moved:.3e}")
    calls = {"unsharded": single}
    counts = {k: [0, 0] for k in ops.counts()}
    for S in (2, 4):
        mesh = make_mesh((S,), ("kf",), devices=[dev])
        t0 = time.perf_counter()
        parts = partition_edges(ii, jj, target, weight, MW, S)
        torch.cuda.synchronize()
        part_ms = 1e3 * (time.perf_counter() - t0)
        for exchange in ("gather_root", "dense_psum"):
            def sharded():
                return dist_ba_solve(mesh, poses0, disps0, intr, dsens, parts[2], parts[3], eta,
                                     parts[0], parts[1], free, *parts[4:], iterations=2,
                                     min_depth=0.25, exchange=exchange)

            ops.reset_counts()
            p2, d2 = sharded()
            torch.cuda.synchronize()
            for k, (a, b) in ops.counts().items():
                counts[k][0] += a
                counts[k][1] += b
            k1 = ops.counts()["ba_blocks"]
            ep, ed = float((p2 - p1).abs().max()), float((d2 - d1).abs().max())
            calls[f"S{S}_{exchange}"] = sharded
            say("parallel", f"sharded BA S={S} {exchange} on cuda:0: max |pose diff| {ep:.3e} "
                            f"(tol 5e-4), max |disp diff| {ed:.3e} (tol 5e-3); K1 launches "
                            f"{k1[0]} (S x 2 = {2 * S}), plain calls {k1[1]}; partition_edges "
                            f"{part_ms:.2f} ms on the host (edge rows {parts[0].shape[1]}, "
                            f"ranges {parts[7].tolist()})")
            if not (ep <= 5e-4 and ed <= 5e-3):
                fail(f"the sharded BA (S={S}, {exchange}) disagrees with the unsharded solve")
            if k1 != (2 * S, 0):
                fail(f"the sharded BA (S={S}, {exchange}) launched K1 {k1}, not {2 * S} times")
        if S == 2:
            s0 = [parts[2][0].contiguous(), parts[3][0].contiguous(), poses0, disps0, intr,
                  torch.as_tensor(parts[0][0], dtype=torch.int64, device=dev),
                  torch.as_tensor(parts[1][0], dtype=torch.int64, device=dev)]
            hold_k1(torch, s0, f"on shard 0 of 2 of the sharded BA (N={parts[0].shape[1]}, "
                               f"MW={MW})")
    samples = {k: [] for k in calls}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for fn in calls.values():
        fn()
    for _ in range(BA_ROUNDS):
        for k, fn in calls.items():
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            samples[k].append(start.elapsed_time(end))
    times = {k: dict(zip(("q1", "median", "q3"), np.percentile(v, [25, 50, 75]).tolist()))
             for k, v in samples.items()}
    for k, q in times.items():
        say("parallel", f"sharded BA {k}: median {q['median']:.2f} ms a call (quartiles "
                        f"{q['q1']:.2f}-{q['q3']:.2f}; {q['median'] / times['unsharded']['median']:.2f}"
                        f" x unsharded) over {BA_ROUNDS} interleaved rounds")
    best = min(("gather_root", "dense_psum"),
               key=lambda e: sum(times[f"S{S}_{e}"]["median"] for S in (2, 4)))
    other = "dense_psum" if best == "gather_root" else "gather_root"
    apart = all(times[f"S{S}_{best}"]["q3"] < times[f"S{S}_{other}"]["q1"] for S in (2, 4))
    say("parallel", f"sharded BA: the faster exchange by summed medians over S = 2 and 4: {best}, "
                    f"{'apart' if apart else 'not apart'} by the quartiles at both S; "
                    f"resolve_exchange's CUDA choice: {CUDA_EXCHANGE}")
    return {k: tuple(v) for k, v in counts.items()}, times


def video_snapshot(droid):
    """A copy of every buffer of a Droid's video (all slots: the trajectory
    filler writes past the keyframes into slots that tracking left behind)
    and its counter, for a later terminate_eva on a fresh engine."""
    import torch

    v = droid.video
    snap = {k: x.clone() if torch.is_tensor(x) else x.copy() for k, x in vars(v).items()
            if torch.is_tensor(x) or isinstance(x, np.ndarray)}
    snap["counter"] = v.counter
    return snap


def engine_from_snapshot(torch, cfg, snap):
    """A Droid of `cfg` (the same seeded weights) whose video holds a copy
    of `snap`."""
    from droid_slam_reserch_tpu_torch.engine import Droid

    droid = Droid(cfg, device="cuda")
    for k, x in snap.items():
        setattr(droid.video, k, x if k == "counter" else x.clone() if torch.is_tensor(x)
                else x.copy())
    return droid


def parallel_engine(torch, ops, snap):
    """On copies of the mono bf16 main path's tracked state: one backend
    step (update_lowmem) with refresh_shards 1 and 2 and an unsharded BA,
    whose refresh outputs (damping, the edges' state, targets and weights)
    must agree bit for bit (the poses and disparities after the BA are
    printed: its index_add_ scatters are atomic on the card); then
    terminate_eva with ba_shards=2 and refresh_shards=2, with the counts set
    to 0 before and read after (K1, K2 bf16 -> fp32 and K3 in the backend,
    K4/K5 bf16 in the filler, no plain version), and its trajectory against
    the main path's unsharded one, within SHARDED_TOL, beside an unsharded
    rerun on the same copy."""
    from droid_slam_reserch_tpu_torch.engine import FactorGraph
    from droid_slam_reserch_tpu_torch.engine.net_ops import update_apply

    cfg, state, tracked, traj_main = snap
    outs = []
    for shards in (1, 2):
        droid = engine_from_snapshot(torch, cfg.replace(ba_shards=0, refresh_shards=shards), state)
        v, t = droid.video, droid.video.counter
        g = FactorGraph(v, update_apply, droid.net.update, max_factors=16 * t)
        g.add_proximity_factors(rad=cfg.backend_radius, nms=cfg.backend_nms,
                                thresh=cfg.backend_thresh, beta=cfg.beta)
        ops.reset_counts()
        with torch.no_grad():
            g.update_lowmem(steps=1)
        torch.cuda.synchronize()
        outs.append(([v.poses[:t].clone(), v.disps[:t].clone(), v.damping[:t].clone(),
                      g.net.clone(), g.target.clone(), g.weight.clone()], g.chunks, ops.counts()))
        del droid, g
    same = [bool(torch.equal(a, b)) for a, b in zip(outs[0][0], outs[1][0])]
    d_pose, d_disp = (float((a - b).abs().max()) for a, b in zip(outs[0][0][:2], outs[1][0][:2]))
    say("parallel", f"refresh on the card, one update_lowmem step over {len(outs[0][0][3])} edges "
                    f"in {outs[0][1][0]} chunks of {outs[0][1][1]}: refresh_shards=2 against 1, "
                    f"bit-equal (damping, net, target, weight): {same[2:]}; after the step's "
                    f"unsharded BA (its scatter-adds are atomic on the card) poses bit-equal "
                    f"{same[0]}, max |diff| {d_pose:.3e}, disps {same[1]}, {d_disp:.3e}; K2 bf16 "
                    f"-> fp32 launches {outs[0][2]['corr_build_bf16_f32'][0]} and "
                    f"{outs[1][2]['corr_build_bf16_f32'][0]}")
    if not all(same[2:]):
        fail("the sharded refresh is not bit-equal to the unsharded one on the card")
    del outs

    stream = [(t, img, INTR_EUROC) for t, img in tracked]
    trajs, counts = {}, None
    for name, kw in (("unsharded", {}), ("sharded", {"ba_shards": 2, "refresh_shards": 2})):
        droid = engine_from_snapshot(torch, cfg.replace(**kw), state)
        ops.reset_counts()
        t0 = time.time()
        trajs[name] = droid.terminate_eva(iter(stream))
        torch.cuda.synchronize()
        secs = time.time() - t0
        if name == "sharded":
            counts = ops.counts()
        what = kw or "ba_shards and refresh_shards auto: unsharded on one card"
        say("parallel", f"terminate_eva {name} ({what}) on the main path's mono bf16 state "
                        f"({droid.video.counter} keyframes): "
                        f"{secs:.2f} s; backend runs {droid.backend.runs}")
        del droid
        torch.cuda.empty_cache()
    d_rerun = float(np.abs(trajs["unsharded"] - traj_main).max())
    d_shard = float(np.abs(trajs["sharded"] - traj_main).max())
    say("parallel", f"terminate_eva sharded (ba_shards=2, refresh_shards=2) against the main "
                    f"path's: max |diff| {d_shard:.3e} (tol {SHARDED_TOL:.0e}); the unsharded "
                    f"rerun against it: {d_rerun:.3e}; counts (kernel launches, plain calls): "
                    f"{counts}")
    if not (trajs["sharded"].shape == traj_main.shape and np.isfinite(trajs["sharded"]).all()
            and d_shard <= SHARDED_TOL):
        fail("the sharded terminate_eva disagrees with the unsharded one")
    check_counts(counts, "the sharded terminate_eva (mono, bfloat16)", MAIN_KERNELS_BF16,
                 OFF_ENGINE)
    return counts


def parallel_train(torch, ops, root):
    """World size 1 over NCCL: one make_parallel_train_step step against
    make_train_step (64x64, 4 frames, 2 iterations), and cli train (2
    steps, 64x64 crop, 4 frames, 1 iteration, restarts at 0.5) in the group
    against the same command before the group existed; both bit for bit
    (parameters, Adam moments, count; the dataset's unseeded augmentation
    rng seeded alike for both commands).  Returns the counts (no kernel)."""
    import contextlib
    import io
    import socket

    import torch.distributed as dist

    from droid_slam_reserch_tpu_torch import cli
    from droid_slam_reserch_tpu_torch.geom import neighbourhood_graph
    from droid_slam_reserch_tpu_torch.parallel import (init_distributed, make_mesh,
                                                       make_parallel_train_step)
    from droid_slam_reserch_tpu_torch.train import TrainConfig, init_train_state, load_ckpt
    from droid_slam_reserch_tpu_torch.train.step import make_train_step

    write_tartan_training_scene(os.path.join(root, "tartan_train"))
    argv = ["train", "--datapath", os.path.join(root, "tartan_train"), "--steps", "2",
            "--n_frames", "4", "--iters", "1", "--image_size", "64", "64", "--save_every", "1",
            "--restart_prob", "0.5"]
    orig_rng = np.random.default_rng

    def run_cli(name):
        np.random.default_rng = lambda seed=None: orig_rng(4321 if seed is None else seed)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(argv + ["--name", name])
        finally:
            np.random.default_rng = orig_rng
        torch.cuda.synchronize()
        return load_ckpt(os.path.join(root, "checkpoints", f"{name}_000002.npz"))

    cwd = os.getcwd()
    os.chdir(root)
    ops.reset_counts()
    # deterministic cuDNN and scatter-adds, so that two runs of one step can
    # be compared bit for bit; each comparison is also made between two
    # single-process runs
    deterministic = (torch.backends.cudnn.deterministic,
                     torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        t0 = time.time()
        plain = run_cli("plain")
        t_plain = time.time() - t0
        plain2 = run_cli("plain2")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t0 = time.time()
        rank, world = init_distributed(f"127.0.0.1:{port}", 1, 0, backend="nccl")
        t_init = time.time() - t0
        try:
            P, H, W = 4, 64, 64
            cfg = TrainConfig(batch=1, n_frames=P, iters=2)
            item = train_scene(np.random.default_rng(2), P, H, W)
            batch = {k: torch.from_numpy(np.ascontiguousarray(x[None])).cuda()
                     for k, x in zip(("images", "poses", "disps", "intrinsics"), item)}
            ii, jj = (torch.as_tensor(np.asarray(x, np.int64)) for x in neighbourhood_graph(P, 2))
            params, opt = init_train_state(cfg, device="cuda")
            ref = make_train_step(cfg, ii.cuda(), jj.cuda())(params, opt, batch)
            ref2 = make_train_step(cfg, ii.cuda(), jj.cuda())(params, opt, batch)
            mesh = make_mesh((1,), ("dp",), group=dist.group.WORLD)
            step, prepare = make_parallel_train_step(cfg, ii, jj, mesh)
            got = step(*prepare(params, opt, batch))
            torch.cuda.synchronize()
            same_step = same_state(got, ref)
            same_ref = same_state(ref2, ref)
            t0 = time.time()
            grouped = run_cli("grouped")
            t_grouped = time.time() - t0
        finally:
            dist.destroy_process_group()
    finally:
        os.chdir(cwd)
        torch.backends.cudnn.deterministic = deterministic[0]
        torch.use_deterministic_algorithms(deterministic[1])
    counts = ops.counts()
    same_cli = plain[2] == grouped[2] == 2 and same_state(grouped[:2], plain[:2])
    same_plain = same_state(plain2[:2], plain[:2])
    say("parallel", f"training at world size {world} over NCCL (rank {rank}, group made in "
                    f"{t_init:.2f} s): make_parallel_train_step against make_train_step, "
                    f"bit-equal: {same_step} (two make_train_step runs: {same_ref}); cli train 2 "
                    f"steps in the group ({t_grouped:.1f} s) against without it "
                    f"({t_plain:.1f} s), bit-equal checkpoints: {same_cli} (two runs without "
                    f"it: {same_plain})")
    if not (same_step and same_cli):
        fail("training at world size 1 over NCCL differs from the single-process step"
             + ("" if same_ref and same_plain else " (and single-process runs differ from "
                                                   "each other: the step is not deterministic)"))
    if any(a or b for a, b in counts.values()):
        fail(f"training called a kernel or a plain version: {counts}")
    return counts


def same_state(a, b):
    """(params, opt_state[, metrics]) equal bit for bit."""
    return (all(torch_equal(a[0][k], b[0][k]) for k in b[0])
            and all(torch_equal(a[1][m][k], b[1][m][k]) for m in ("mu", "nu") for k in b[0])
            and a[1]["count"] == b[1]["count"]
            and (len(a) < 3 or all(torch_equal(a[2][k], b[2][k]) for k in b[2])))


def torch_equal(x, y):
    return x.shape == y.shape and bool((x == y).all())


N_JPEG = 24           # ETH3D_CONFIG's warmup is 20


def write_jpeg_eth3d(root, folder="jpeg"):
    """An ETH3D sequence whose frames are color/*.jpg (no rgb/): the
    committed fixtures tests/data/<folder>/ (739x458, 4 px of pan a frame;
    jpeg_progressive/ holds their progressive versions) cycled forth and
    back over N_JPEG frames, depth_frames' depth as 16-bit PNGs, ETH3D's
    calibration and a ground truth 0.02 m a frame."""
    fixtures = os.path.join(REPO, "tests", "data", folder)
    files = sorted(os.listdir(fixtures))
    order = [k for _ in range(N_JPEG) for k in list(range(len(files))) + list(
        range(len(files) - 2, 0, -1))][:N_JPEG]
    seq = os.path.join(root, "eth3d_" + folder)
    os.makedirs(os.path.join(seq, "color"))
    os.makedirs(os.path.join(seq, "depth"))
    rows = []
    for t, (k, depth) in enumerate(zip(order, depth_frames(N_JPEG, seed=4, H=458, W=739))):
        ts = f"{1305031102.175 + 0.033 * t:.6f}"
        shutil.copy(os.path.join(fixtures, files[k]), os.path.join(seq, "color", ts + ".jpg"))
        write_png(os.path.join(seq, "depth", ts + ".png"), (depth * 1000.0).astype(np.uint16))
        rows.append([float(ts), 0.02 * t, 0.0, 0.01 * t, 0.0, 0.0, 0.0, 1.0])
    np.savetxt(os.path.join(seq, "groundtruth.txt"), np.asarray(rows), fmt="%.6f")
    np.savetxt(os.path.join(seq, "calibration.txt"), np.array([[726.28, 726.28, 354.65, 186.47]]))
    return seq


JPEG_FIXTURES = (("baseline", "jpeg", ".jpg"), ("progressive", "jpeg_progressive", ".jpg"),
                 ("arithmetic sequential", "jpeg_arith", "_seq.jpg"),
                 ("arithmetic progressive", "jpeg_arith", "_prog.jpg"))


def decode_fixtures():
    """Every committed JPEG fixture decoded on this host (imageio.imread,
    as the readers call it): the progressive and arithmetic-coded ones held
    against the digest of cv2.imread's decode committed beside their folder
    (tests/data/<folder>.json); ms a 739x458 frame of each kind."""
    import hashlib

    from droid_slam_reserch_tpu_torch.data import imageio

    data = os.path.join(REPO, "tests", "data")
    ms = {}
    for kind, folder, suffix in JPEG_FIXTURES:
        digests = None
        if os.path.exists(os.path.join(data, folder + ".json")):
            with open(os.path.join(data, folder + ".json")) as f:
                digests = json.load(f)
        files = [f for f in sorted(os.listdir(os.path.join(data, folder))) if f.endswith(suffix)
                 and (suffix != ".jpg" or not f.endswith(("_seq.jpg", "_prog.jpg")))]
        secs = 0.0
        for name in files:
            t0 = time.perf_counter()
            img = imageio.imread(os.path.join(data, folder, name))
            secs += time.perf_counter() - t0
            if digests is not None:
                got = {"sha256": hashlib.sha256(img.tobytes()).hexdigest(),
                       "shape": list(img.shape), "dtype": str(img.dtype)}
                if got != digests[name]:
                    fail(f"JPEG fixture {folder}/{name} decodes to {got}, cv2 to {digests[name]}")
        ms[kind] = 1e3 * secs / len(files)
        say("parallel", f"JPEG {kind}: {len(files)} fixtures of {folder}/ decoded"
                        f"{'' if digests is None else ', each equal to the cv2 digest'}; "
                        f"{ms[kind]:.1f} ms a 739x458 frame on {host_cpu()}")
    return ms


def parallel_jpeg(torch, ops, root, folder="jpeg"):
    """The JPEG reader on tests/data/<folder>/ (baseline frames, or their
    progressive versions): ms a frame of imageio.imread and of eth3d_stream
    (with depth); then the eth3d command (bf16, --depth) on color/*.jpg,
    with the kernel and graph-library counts set to 0 before and read after
    (K1-K5 of bf16 launch, the library's entry points run, no plain
    version): a finite ATE and poses."""
    import contextlib
    import io

    from droid_slam_reserch_tpu_torch import cli, native
    from droid_slam_reserch_tpu_torch.data import eth3d_stream, imageio

    seq = write_jpeg_eth3d(root, folder)
    files = sorted(os.listdir(os.path.join(seq, "color")))
    t0 = time.perf_counter()
    for f in files[:6]:
        img = imageio.imread(os.path.join(seq, "color", f))
    dec_ms = 1e3 * (time.perf_counter() - t0) / 6
    t0 = time.perf_counter()
    n = sum(1 for _ in eth3d_stream(seq, use_depth=True))
    stream_ms = 1e3 * (time.perf_counter() - t0) / n
    ops.reset_counts()
    native.reset_counts()
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        droid = cli.main(["eth3d", "--datapath", seq, "--depth", "--bf16", "--filter_thresh", "-1",
                          "--keyframe_thresh", "0"])
    torch.cuda.synchronize()
    secs = time.time() - t0
    counts = ops.counts()
    graph_counts = native.counts()
    res = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
    ate = res[-1]["ate"]["rmse"] if res and "ate" in res[-1] else float("nan")
    v = droid.video
    finite = bool(torch.isfinite(v.poses[:v.counter]).all())
    say("parallel", f"JPEG {folder}/: imageio.imread {dec_ms:.1f} ms a 739x458 frame, eth3d_stream "
                    f"(color/*.jpg + depth PNGs, resized to {img.shape[1]}x{img.shape[0]} -> "
                    f"{droid.cfg.image_size[1]}x{droid.cfg.image_size[0]}) {stream_ms:.1f} ms a "
                    f"frame; eth3d --depth bf16 on {n} JPEG frames: {v.counter} keyframes in "
                    f"{secs:.1f} s, ATE {ate:.4f}, poses finite {finite}; counts {counts}")
    if not (n == N_JPEG and np.isfinite(ate) and finite):
        fail(f"the eth3d command on the JPEG frames of {folder}/ gave no finite trajectory")
    check_counts(counts, f"the eth3d command on the JPEG frames of {folder}/", MAIN_KERNELS_BF16,
                 OFF_ENGINE)
    check_graph_counts(graph_counts, f"the eth3d command on the JPEG frames of {folder}/")
    del droid
    torch.cuda.empty_cache()
    return counts


def phase_parallel(torch, ops, snap):
    """The parallel/ package and the JPEG reader on one card (see
    parallel_ba, parallel_engine, parallel_train and parallel_jpeg).
    Returns the counts by path."""
    by_path = {}
    t0 = time.time()
    by_path["parallel_ba"], times = parallel_ba(torch, ops)
    say("time", f"parallel sharded BA: {time.time() - t0:.1f} s")
    t0 = time.time()
    by_path["parallel_terminate_eva_bf16"] = parallel_engine(torch, ops, snap)
    say("time", f"parallel engine: {time.time() - t0:.1f} s")
    root = tempfile.mkdtemp(prefix="droid_parallel_")
    try:
        t0 = time.time()
        by_path["parallel_train"] = parallel_train(torch, ops, root)
        say("time", f"parallel training: {time.time() - t0:.1f} s")
        t0 = time.time()
        by_path["parallel_eth3d_jpeg_bf16"] = parallel_jpeg(torch, ops, root)
        say("time", f"parallel JPEG: {time.time() - t0:.1f} s")
        t0 = time.time()
        jpeg_ms = decode_fixtures()
        by_path["parallel_eth3d_jpeg_progressive_bf16"] = parallel_jpeg(torch, ops, root,
                                                                        "jpeg_progressive")
        say("time", f"parallel JPEG fixtures and progressive eth3d: {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    with open(os.path.join(OUT_DIR, "parallel.json"), "w") as f:
        json.dump({"sharded_ba_ms": times, "jpeg_ms_a_frame": jpeg_ms}, f, indent=1)
    return by_path


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

    laps = [time.time()]

    def lap(phase):
        laps.append(time.time())
        say("time", f"{phase}: {laps[-1] - laps[-2]:.1f} s, {laps[-1] - laps[0]:.1f} s in all")

    t0 = time.time()
    build.build(ptxas_verbose=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        f.write(build.BUILD_LOG["ptxas"])
    n_src = sum(f.endswith(".cu") for f in os.listdir(build.CSRC))
    say("build", f"nvcc sm_90a, {n_src} sources in parallel: "
                 f"{time.time() - t0:.1f} s ({build.LIB_PATH})")
    build.library()
    from droid_slam_reserch_tpu_torch import native

    t0 = time.time()
    native.build()
    native.have_native()
    say("build", f"graph library: {' '.join(native.CXX)} csrc/graph_ops.cpp: "
                 f"{time.time() - t0:.1f} s ({native.LIB_PATH})")
    lap("build")

    profiling = "--profile" in sys.argv[1:]
    rows = phase_kernels(torch)
    lap("kernels")
    rows.update(phase_kernels_bf16(torch))
    lap("kernels-bf16")
    by_path = {"drift": phase_drift(torch, ops), "drift_bf16": phase_drift(torch, ops, "bfloat16")}
    lap("drift")
    by_path["parallel_card_vs_cpu"] = phase_card_vs_cpu(
        torch, ops, "float32", ("mono", "stereo", "rgbd", "upsample", "sharded"))
    phase_card_vs_cpu(torch, ops, "bfloat16", ("mono", "stereo"))
    lap("card-vs-cpu")
    frames = {"mono": (euroc_frames(N_MAIN + (12 if profiling else 0)), None),
              "stereo": (euroc_frames(N_MAIN, shift=STEREO_SHIFT), None),
              "rgbd": (euroc_frames(N_RGBD, seed=1, H=480, W=640),
                       depth_frames(N_RGBD, seed=1, H=480, W=640))}
    speed = {}
    for mode, dtype in (("mono", "float32"), ("mono", "bfloat16"), ("stereo", "float32"),
                        ("stereo", "bfloat16"), ("rgbd", "bfloat16"), ("rgbd", "float32")):
        kernels = MAIN_KERNELS if dtype == "float32" else MAIN_KERNELS_BF16
        sfx = ("" if mode == "mono" else "_" + mode) + ("" if dtype == "float32" else "_bf16")
        imgs, depths = frames[mode]
        n = N_RGBD if mode == "rgbd" else N_MAIN
        cap = None if mode == "mono" else EngineInputs()
        sel = Selections() if (mode, dtype) == ("mono", "float32") else None
        counts, droid, tracked, fps = phase_main_path(torch, ops, imgs[:n], dtype, kernels, mode,
                                                      depths, cap)
        if sel is not None:
            front = sel.calls[-1]
            sel.calls.clear()
        if profiling and mode == "mono":
            tracked += phase_profile(torch, droid, imgs[N_MAIN:], float(N_MAIN), tag=sfx)
        if (mode, dtype) == ("mono", "bfloat16"):      # the parallel phase's state
            snap = (droid.cfg, video_snapshot(droid), list(tracked))
        counts_term, secs, traj = phase_terminate(
            torch, ops, droid, tracked, profiling and mode == "mono", kernels,
            INTR_ETH3D if mode == "rgbd" else INTR_EUROC, cap)
        if sel is not None:
            back, graph_cfg = sel.calls[0], droid.cfg
            sel.restore()
        if (mode, dtype) == ("mono", "bfloat16"):
            snap += (traj,)
        by_path["track" + sfx], by_path["terminate_eva" + sfx] = counts, counts_term
        speed[mode, dtype] = (fps, secs)
        if dtype == "float32" and mode != "rgbd":
            bucket = droid.cfg.edge_bucket
            n_back = max(r["edges"] for r in droid.backend.runs)
            phase_k1_backend(torch, -(-n_back // bucket) * bucket, droid.video.counter,
                             droid.video.counter if mode == "stereo" else 0)
        del droid
        torch.cuda.empty_cache()
        if cap is not None:
            cap.restore()
            say("engine-inputs", f"{mode} {dtype}: {cap.retained_mib():.1f} MiB of kernel "
                                 f"inputs retained by the capture")
            hold_engine_inputs(torch, cap, f"{mode} {dtype} main path", mode == "stereo")
            del cap
            torch.cuda.empty_cache()
    for mode in ("mono", "stereo", "rgbd"):
        (f16, s16), (f32, s32) = speed[mode, "bfloat16"], speed[mode, "float32"]
        say("main-path", f"{mode}: bf16 against fp32 in this run: {f16:.2f} against {f32:.2f} "
                         f"frames/s after initialisation, terminate_eva {s16:.2f} against "
                         f"{s32:.2f} s")
    lap("main-path")
    graph_times = phase_graph_library(front, back, graph_cfg)
    with open(os.path.join(OUT_DIR, "graph_library.json"), "w") as f:
        json.dump(graph_times, f, indent=1)
    lap("graph-library")
    root = tempfile.mkdtemp(prefix="droid_cli_")
    try:
        t0 = time.time()
        paths = make_cli_datasets(root)
        say("cli", f"datasets written in {time.time() - t0:.1f} s under a temporary directory")
        counts, cli_track = phase_cli(torch, ops, paths, root)
        by_path.update(counts)
        lap("cli")
        for dtype in ("float32", "bfloat16"):
            counts, A = phase_multisession(
                torch, ops, paths, root, dtype,
                cli_track["cli_euroc_stereo_bf16"] if dtype == "bfloat16" else None)
            by_path.update(counts)
            lap(f"multisession {dtype}")
        phase_probe_spread(torch, A)
        del A
        for dtype in ("float32", "bfloat16"):
            phase_multisession_card_vs_cpu(torch, dtype)
        lap("multisession probe spread, card vs CPU")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    by_path["profile_frontend"] = phase_profile_frontend(torch, ops)
    by_path["profile_frontend_bf16"] = phase_profile_frontend(torch, ops, "bfloat16")
    lap("profile-frontend")
    by_path["train"], train_results = phase_train(torch, ops)
    with open(os.path.join(OUT_DIR, "train.json"), "w") as f:
        json.dump(train_results, f, indent=1)
    lap("train")
    by_path.update(phase_parallel(torch, ops, snap))
    del snap
    lap("parallel")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output",
          flush=True)

    src, pallas = "droid_slam_reserch_tpu_torch/csrc/", "droid_slam_reserch_tpu/ops/pallas_corr.py:"
    meta = {
        "ba_blocks": (src + "ba_blocks.cu", "droid_slam_reserch_tpu/ops/pallas_ba.py:139"),
        "corr_build": (src + "corr_build.cu", pallas + "182"),
        "corr_lookup": (src + "corr_lookup.cu", pallas + "265"),
        "corr_build_windows": (src + "corr_windows_build.cu", pallas + "715"),
        "corr_lookup_windows": (src + "corr_windows_lookup.cu", pallas + "474"),
        "corr_lookup_pmajor": (src + "corr_pmajor_lookup.cu", pallas + "109"),
        "corr_extract_windows": (src + "corr_extract_windows.cu", pallas + "391"),
        "corr_build_windows_levels": (src + "corr_windows_build.cu", pallas + "604"),
        # the bf16 instantiations of K2 (bf16 and fp32 levels) and K3-K8
        "corr_build_bf16": (src + "corr_build.cu", pallas + "182"),
        "corr_build_bf16_f32": (src + "corr_build.cu", pallas + "182"),
        "corr_lookup_bf16": (src + "corr_lookup.cu", pallas + "265"),
        "corr_build_windows_bf16": (src + "corr_windows_build.cu", pallas + "715"),
        "corr_lookup_windows_bf16": (src + "corr_windows_lookup.cu", pallas + "474"),
        "corr_lookup_pmajor_bf16": (src + "corr_pmajor_lookup.cu", pallas + "109"),
        "corr_extract_windows_bf16": (src + "corr_extract_windows.cu", pallas + "391"),
        "corr_build_windows_levels_bf16": (src + "corr_windows_build.cu", pallas + "604"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = rows[name]
        # each path's count (the engine's main path, track and terminate_eva,
        # in fp32 and bf16; the frontend profiler; the drift phases), and their sum
        paths = {path: c[name][0] for path, c in by_path.items()}
        if sum(paths.values()) == 0:
            fail(f"{name} was launched on no path")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": sum(paths.values()), "launches_by_path": paths,
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "ops_route": r.get("ops_route", "fp32"),
                        # the lookups' times under a smooth 4-px pan (the others: random
                        # coords); K1's call as a whole, on the device and on the host clock
                        **{k: r[k] for k in ("ms_pan4", "library_ms_pan4", "call_ms", "host_ms",
                                             "sector_bound_ms") if k in r}})
        # K2 also at E=1 (motion filter) and EB=64 (backend); K6-K8 bf16 at E=1
        for shape in ("e1", "eb64"):
            if f"{name}_{shape}" in rows:
                kernels[-1].update({f"{k}_{shape}": v for k, v in rows[f"{name}_{shape}"].items()})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
