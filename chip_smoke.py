#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (one line each; any failure exits nonzero):
1. build   nvcc-compiles the port's CUDA kernels from csrc/ (sm_90a), one
           process per source, all started together;
2. kernels prints what ptxas made of the correlation build (K2), the BA
           blocks (K1), the window-cache build (K4, K8), the windowed lookup
           (K5) and the pyramid lookups (K3, K6) and K4's occupancy; holds
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
           F.grid_sample nearest for K7's window extraction);
3. drift   the frontend's windowed lookup with coords that leave the cached
           windows: the fallback (K2 once, K3) is taken, counted and exact;
4. card vs CPU  the oracle frontend and backend gates on the card (ATE <
           0.01), and the port's Droid.track + terminate_eva at 64x96 on the
           card against the same run with device="cpu";
5. main path    Droid.track with EUROC_CONFIG (mono, 320x512, fp32, full
           network widths, seeded random weights) over synthetic frames, then
           Droid.terminate_eva over the same frames (backend 7 + 12 steps,
           trajectory filler); before each of the two, every kernel's launch
           count and every plain version's call count is set to 0, and read
           just after; then K1 held at the largest edge count of the
           backend's graphs in that run;
6. profile-frontend  the frontend profiler (tools/profile_frontend.py) at
           bench.py's shape, E = 48 edges over a 24-frame window at 40x64:
           every section on the card, with the counts set to 0 before and
           read after; every kernel must launch and no plain version run.
Then it prints the card's name and power limit, one JSON line describing
the kernels, and as its last line the device JSON.  The script needs only
torch, numpy and scipy, and the CUDA toolkit for nvcc.

    python3 chip_smoke.py --profile

adds a phase between tracking and terminate_eva: 12 more keyframes, half of
them timed per stage on the host clock and half under torch.profiler, with
the device kernel time grouped and the device's idle share printed, and
runs terminate_eva under torch.profiler too; the full tables go to
chiprun_out/profile_main_path.txt and chiprun_out/profile_terminate.txt.
"""
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense TF32 in the tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12

# main-path shapes: EuRoC 320x512 -> 40x64 feature maps, 48 active edges
E_MAIN, H8, W8, C = 48, 40, 64, 128
INTR_EUROC = np.array([296.3, 290.1, 250.2, 168.1], np.float32)
N_MAIN = 40                    # frames of the main path
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


def euroc_frames(n, seed=0, H=320, W=512, step=4):
    """Smoothed random texture panning `step` px per frame, 3-channel uint8."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.RandomState(seed)
    base = gaussian_filter(rng.rand(H + 8, W + step * n + 8), 2.0)
    base = (base - base.min()) / (base.max() - base.min()) * 255.0
    return [np.repeat(base[4:4 + H, 4 + step * t: 4 + step * t + W, None], 3, -1).astype(np.uint8)
            for t in range(n)]


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
    template's pixel tile and, for K8's instantiation of K4's template, the
    word levels."""
    import re

    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = next((k for k in kernels if k in m.group(1)), None)
            args = re.search(r"ILi(\d+)E(?:Lb([01])E)?", m.group(1))
            if name and args:
                name += f"<{args.group(1)} pixels{', levels' if args.group(2) == '1' else ''}>"
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


def hold_k1(torch, args, what):
    """K1 against its plain version on `args`, 2e-4 * max(1, |ref|) per
    output; returns the largest error."""
    from droid_slam_reserch_tpu_torch.ops import cuda_ba

    out = cuda_ba.ba_system_blocks(*args)
    ref = cuda_ba.build_system_blocks(*args)
    torch.cuda.synchronize()
    err, ok = 0.0, True
    for k in ref:
        d = float((out[k] - ref[k]).abs().max())
        err = max(err, d)
        ok &= d <= 2e-4 * max(1.0, float(ref[k].abs().max()))
    say("kernels", f"K1 ba_blocks {what}: max_abs_err {err:.3e} (tol 2e-4*max(1,|ref|) per "
                   f"output)")
    if not ok:
        fail(f"K1 disagrees with its plain version ({what})")
    return err


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
                             ("corr_build_kernel", "ba_blocks_kernel", "windows_build_kernel",
                              "windows_lookup_kernel", "corr_lookup_kernel",
                              "pmajor_lookup_kernel")):
        say("kernels", f"ptxas: {line}")
    info2 = (ctypes.c_int * 2)()
    build.library().corr_build_info(info2)
    say("kernels", f"K2: {info2[0]} bytes of dynamic shared memory a block, {info2[1]} "
                   f"block(s) resident per SM")
    info = (ctypes.c_int * 4)()
    build.library().corr_windows_build_info(H8, W8, info)
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
                       f"{lib_ms3['random']:.4f}, bound {bound3[0]:.4f} by {bound3[1]}), K6 "
                       f"{ms6['random']:.4f} ms (plain {plain_ms6:.4f}, bound {bound6[0]:.4f} by "
                       f"{bound6[1]}); grid_sample against K3 {err3_lib:.3e} (tol {tol_lib:.1e}: "
                       f"its [-1, 1] grid rounds the positions)")
        if not err3_lib <= tol_lib:
            fail(f"F.grid_sample does not compute K3's function at E={E}")
        if E == E_MAIN:
            rows["corr_build"] = dict(max_abs_err=err2, ms=ms2, plain_ms=plain_ms2,
                                      library_ms=lib_ms2, bound_ms=bound2[0], bound_by=bound2[1],
                                      ops_route="tf32x3")
            for name, err, ms, plain_ms, bnd in (("corr_lookup", err3, ms3, plain_ms3, bound3),
                                                 ("corr_lookup_pmajor", err6, ms6, plain_ms6,
                                                  bound6)):
                rows[name] = dict(max_abs_err=err, ms=ms["random"], plain_ms=plain_ms,
                                  library_ms=lib_ms3["random"], bound_ms=bnd[0], bound_by=bnd[1],
                                  ms_pan4=ms["pan4"], library_ms_pan4=lib_ms3["pan4"])
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
                       f"{lib_ms5:.4f}, bound {bound5[0]:.4f} by {bound5[1]}); grid_sample "
                       f"against K5 {err5_lib:.3e} (tol {tol_lib:.1e})")
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
                                               bound_ms=bound5[0], bound_by=bound5[1])

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
        need7 = 0
        for l, (h, w) in enumerate(sizes):
            WH, WW = win_shape(h, w)
            r0 = b7[:, 2 * l].long() - 8
            x0 = b7[:, 2 * l + 1].long() - 8
            rows_in = (torch.minimum(r0 + WH, torch.tensor(h, device=dev)) - r0.clamp_min(0))
            cols_in = (torch.minimum(x0 + WW, torch.tensor(w, device=dev)) - x0.clamp_min(0))
            need7 += int((rows_in.clamp_min(0) * cols_in.clamp_min(0)).sum())
        bound7 = bound(0, (need7 + c0.numel() + w7.numel() + b7.numel()) * 4)
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
                       f"x4 {lib_ms7:.4f}, bound {bound7[0]:.4f} by {bound7[1]}); K8 {ms8:.4f} ms "
                       f"(plain {plain_ms8:.4f}, torch.bmm volume {lib_ms2:.4f}, bound "
                       f"{bound8[0]:.4f} by {bound8[1]}, 3xTF32)")
        if E == E_MAIN:
            rows["corr_extract_windows"] = dict(max_abs_err=max(err7, err74), ms=ms7,
                                                plain_ms=plain_ms7, library_ms=lib_ms7,
                                                bound_ms=bound7[0], bound_by=bound7[1])
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


def k1_bound(N, MW):
    """K1's least time at N edges over MW frames at 40x64: reads target,
    weight, disps, poses, ii/jj (int64) and the intrinsics once; writes H,
    v, E, C and w once."""
    HW = H8 * W8
    return bound(N * HW * K1_OPS_PER_PIXEL + N * K1_OPS_PER_EDGE,
                 (N * HW * 4 + MW * HW + MW * 7 + 4 * N + 4
                  + N * (144 + 12) + N * 12 * HW + N * HW * 2) * 4)


def phase_k1_backend(torch, n_edges, MW):
    """K1 at the backend's largest graph of the main path (n_edges padded to
    the engine's edge bucket, over MW frames), against its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    hold_k1(torch, k1_problem(torch, gen, n_edges, MW, self_edges=0),
            f"N={n_edges} over {MW} frames, the main path's largest backend graph")


def phase_drift(torch, ops):
    """The frontend's per-call correlation (engine.factor_graph.WindowedLookup)
    at the main path's shapes: a small drift reads the windows (K5), drifts
    past the windows take the full lookup (K2 built once, K3 each time), and
    every answer equals the plain full lookup."""
    from droid_slam_reserch_tpu_torch.engine import factor_graph as fg
    from droid_slam_reserch_tpu_torch.geom import coords_grid
    from droid_slam_reserch_tpu_torch.ops import cuda_corr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    E, P = E_MAIN, H8 * W8
    f1 = torch.randn(E, H8, W8, C, generator=gen, device=dev)
    f2 = torch.randn(E, H8, W8, C, generator=gen, device=dev)
    c0 = (coords_grid(H8, W8, device=dev).reshape(1, P, 2)
          + torch.randn(E, P, 2, generator=gen, device=dev)).contiguous()
    ops.reset_counts()
    fg.reset_corr_rounds()
    lookup = fg.WindowedLookup(f1, f2, c0)
    drifts = (1.0, 12.0, -12.0)
    outs = [lookup((c0 + d).contiguous()) for d in drifts]
    torch.cuda.synchronize()
    counts, rounds = ops.counts(), dict(fg.CORR_ROUNDS)
    levels = cuda_corr.corr_build_plain(f1, f2)
    err = 0.0
    for d, out in zip(drifts, outs):
        ref = cuda_corr.corr_lookup_plain(levels, (c0 + d).contiguous())
        err = max(err, float((out - ref).abs().max()) / max(1.0, float(ref.abs().max())))
    say("drift", f"E={E}: drifts {drifts} px -> rounds {rounds}; launches K4 "
                 f"{counts['corr_build_windows'][0]}, K5 {counts['corr_lookup_windows'][0]}, "
                 f"K2 {counts['corr_build'][0]}, K3 {counts['corr_lookup'][0]}; max error "
                 f"against the plain full lookup {err:.3e} relative (tol 1e-5)")
    want = {"corr_build_windows": 1, "corr_lookup_windows": 1, "corr_build": 1, "corr_lookup": 2}
    if rounds != {"windowed": 1, "fallback": 2} or any(counts[k][0] != n for k, n in want.items()):
        fail("the drift fallback was not taken as the rule says")
    if not err <= 1e-5:
        fail("the windowed lookup or its fallback is not exact")


FRONTEND_KERNELS = ("ba_blocks", "corr_build_windows", "corr_lookup_windows")
BACKEND_KERNELS = ("ba_blocks", "corr_build", "corr_lookup")
# the engine's; K6-K8 are on no engine path
MAIN_KERNELS = tuple(dict.fromkeys(FRONTEND_KERNELS + BACKEND_KERNELS))


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
    if (any(counts[k][0] == 0 for k in FRONTEND_KERNELS)
            or any(p != 0 for _, p in counts.values())):
        fail(f"oracle gate did not run through every kernel of the frontend: {counts}")

    ops.reset_counts()
    graph = oracle.drive_backend(v, gt, steps=2, itrs=2)
    torch.cuda.synchronize()
    counts = ops.counts()
    err, _ = ate_rmse(oracle.cam_centers(v.poses[:oracle.T]), oracle.cam_centers(gt[0]),
                      align=True, correct_scale=True)
    say("card-vs-cpu", f"oracle backend gate on the card (2 update_lowmem steps over "
                       f"{len(graph.ii)} edges): ATE {err:.3e} (limit 1e-2), launches {counts}")
    if not err < 0.01:
        fail("oracle backend gate on the card")
    if (any(counts[k][0] == 0 for k in BACKEND_KERNELS)
            or any(p != 0 for _, p in counts.values())):
        fail(f"oracle backend gate did not run through K1, K2 and K3: {counts}")

    params = init_params(seed=0)
    intr = np.array([60.0, 60.0, 48.0, 32.0], np.float32)
    runs = {}
    for device in ("cuda", "cpu"):
        d = Droid(small_config(DroidConfig), params=params, device=device)
        rng = np.random.RandomState(0)
        frames = [synth_small(t, rng) for t in range(10)]
        hist = []
        for t, img in enumerate(frames):
            d.track(float(t), img, intrinsics=intr)
            hist.append((d.video.counter, d.frontend.graph.ii.copy(), d.frontend.graph.jj.copy()))
        poses = d.video.poses[:d.video.counter].cpu().numpy().copy()   # terminate_eva moves them
        traj = d.terminate_eva(iter([(float(t), img, intr) for t, img in enumerate(frames)]))
        runs[device] = (hist, poses, traj)
    (h_gpu, p_gpu, tr_gpu), (h_cpu, p_cpu, tr_cpu) = runs["cuda"], runs["cpu"]
    same_graph = all(a[0] == b[0] and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
                     for a, b in zip(h_gpu, h_cpu))
    dp = float(np.abs(p_gpu - p_cpu).max()) if p_gpu.shape == p_cpu.shape else float("inf")
    dt = float(np.abs(tr_gpu - tr_cpu).max()) if tr_gpu.shape == tr_cpu.shape else float("inf")
    say("card-vs-cpu", f"Droid.track 64x96, 10 frames: keyframes {h_gpu[-1][0]} vs "
                       f"{h_cpu[-1][0]}, edges equal every frame: {same_graph}, "
                       f"max |pose diff| {dp:.3e} (tol 1e-3); terminate_eva (backend 2 + 3 "
                       f"steps, filler): trajectory {tr_gpu.shape}, max |diff| {dt:.3e} (tol 1e-3)")
    if not (same_graph and dp <= 1e-3):
        fail("the card run and the CPU run of Droid.track disagree")
    if not (tr_gpu.shape == (10, 7) and np.isfinite(tr_gpu).all() and dt <= 1e-3):
        fail("the card run and the CPU run of Droid.terminate_eva disagree")


def check_counts(counts, what, kernels=MAIN_KERNELS):
    """Every kernel of `kernels` launched, and no plain version ran."""
    for name, (launches, plain) in counts.items():
        if (name in kernels and launches == 0) or plain != 0:
            fail(f"{name}: {launches} kernel launches, {plain} plain calls on {what}")


def phase_main_path(torch, ops, frames):
    """Droid.track over EuRoC-size frames; returns the kernel counts, the
    Droid and the tracked (tstamp, image) pairs."""
    from droid_slam_reserch_tpu_torch.engine import Droid
    from droid_slam_reserch_tpu_torch.engine import factor_graph as fg
    from droid_slam_reserch_tpu_torch.utils import EUROC_CONFIG

    cfg = EUROC_CONFIG.replace(filter_thresh=-1.0, keyframe_thresh=0.0)
    n_frames = len(frames)
    droid = Droid(cfg, device="cuda")
    torch.cuda.synchronize()

    ops.reset_counts()
    fg.reset_corr_rounds()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    t_init = None
    for t, img in enumerate(frames):
        droid.track(float(t), img, intrinsics=INTR_EUROC)
        if t_init is None and droid.frontend.is_initialized:
            torch.cuda.synchronize()
            t_init = (time.time(), t + 1, droid.video.counter, dict(fg.CORR_ROUNDS))
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
    rounds = dict(fg.CORR_ROUNDS)
    steady_rounds = sum(rounds.values()) - sum(t_init[3].values())
    steady_kf = n_kf - t_init[2]
    say("main-path", f"track: EUROC_CONFIG mono 320x512 fp32: {n_frames} frames, {n_kf} "
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
    check_counts(counts, "the main path's track")
    return counts, droid, [(float(t), img) for t, img in enumerate(frames)]


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


def phase_terminate(torch, ops, droid, tracked, profiling=False):
    """Droid.terminate_eva over every tracked frame: the backend's two runs
    and the trajectory filler, timed apart on the host clock.  With
    profiling, the call runs under torch.profiler (whose overhead then
    enters the host-clock times)."""
    from droid_slam_reserch_tpu_torch.engine import factor_graph as fg

    n_kf = droid.video.counter
    backend = droid.backend = Timed(torch, droid.backend)
    filler = droid.traj_filler = Timed(torch, droid.traj_filler)
    call = Timed(torch, droid.terminate_eva)
    stream = iter([(t, img, INTR_EUROC) for t, img in tracked])
    ops.reset_counts()
    fg.reset_corr_rounds()
    if profiling:
        traj = profiled(torch, lambda: call(stream), "terminate_eva", 1, "call",
                        "profile_terminate.txt")
    else:
        traj = call(stream)
    counts = ops.counts()
    rounds = dict(fg.CORR_ROUNDS)
    runs = backend.fn.runs
    say("main-path", f"terminate_eva: {call.seconds[0]:.2f} s: backend {backend.seconds[0]:.2f} s "
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
    check_counts(counts, "the main path's terminate_eva")
    return counts


def phase_profile_frontend(torch, ops):
    """tools/profile_frontend.py at bench.py's shape on the card; returns the
    kernel counts of the run."""
    from droid_slam_reserch_tpu_torch.engine import factor_graph as fg
    from droid_slam_reserch_tpu_torch.tools.profile_frontend import FULL, ROUNDS, profile

    ops.reset_counts()
    fg.reset_corr_rounds()
    res = profile(**FULL, device="cuda", iters=10)
    torch.cuda.synchronize()
    counts, rounds = ops.counts(), dict(fg.CORR_ROUNDS)
    torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    say("profile-frontend", f"correlation rounds of fused_rounds {rounds}; counts (kernel "
                            f"launches, plain calls): {counts}")
    errs = {k: res[k] for k in ("k3_max_err", "k6_max_err", "k5_max_err")}
    if not all(v <= 1e-5 for v in errs.values()):
        fail(f"a lookup of the profiler disagrees with the plain one beyond 1e-5: {errs}")
    if rounds["fallback"] or rounds["windowed"] % ROUNDS:
        fail(f"fused_rounds left the window cache in the profiler: {rounds}")
    check_counts(counts, "the frontend profiler", kernels=tuple(counts))
    return counts


KERNEL_GROUPS = (      # substrings of device kernel names -> group, first match wins
    ("port K2 corr_build", ("corr_build_kernel",)),
    ("port K3 corr_lookup", ("corr_lookup_kernel",)),
    ("port K4 corr_build_windows", ("windows_build_kernel",)),
    ("port K5 corr_lookup_windows", ("windows_lookup_kernel",)),
    ("port K6 corr_lookup_pmajor", ("pmajor_lookup_kernel",)),
    ("port K7 corr_extract_windows", ("extract_windows_kernel",)),
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
    groups = {}
    for us, _, name in dev:
        low = name.lower()
        g = next((g for g, keys in KERNEL_GROUPS if any(s in low for s in keys)), "other kernels")
        groups[g] = groups.get(g, 0.0) + us
    say("profile", f"{what} under torch.profiler: wall {wall_us / 1e3 / per:.1f} ms per {unit}, "
                   f"device busy {busy_us / 1e3 / per:.1f} ms ({100 * busy_us / wall_us:.1f} %), "
                   f"idle {100 * (1 - busy_us / wall_us):.1f} %")
    say("profile", f"device time per {unit} by group: " + "; ".join(
        f"{g} {us / 1e3 / per:.2f} ms" for g, us in sorted(groups.items(), key=lambda x: -x[1])))
    path = os.path.join(OUT_DIR, filename)
    with open(path, "w") as f:
        f.write(f"{what}: wall {wall_us:.0f} us, device busy {busy_us:.0f} us\n\n")
        f.write("device kernels by total time (us, count, name):\n")
        for us, n, name in dev:
            f.write(f"{us:12.1f} {n:7d}  {name[:160]}\n")
        f.write("\n" + avgs.table(sort_by="self_cpu_time_total", row_limit=40))
    say("profile", f"tables in {os.path.relpath(path, REPO)}")
    return out


def phase_profile(torch, droid, frames, t_base, intr=INTR_EUROC):
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

    profiled(torch, track_rest, f"{len(rest)} keyframes", len(rest), "keyframe",
             "profile_main_path.txt")
    return [(t_base + k, img) for k, img in enumerate(frames)]


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
    phase_drift(torch, ops)
    phase_card_vs_cpu(torch, ops)
    frames = euroc_frames(N_MAIN + (12 if profiling else 0))
    counts, droid, tracked = phase_main_path(torch, ops, frames[:N_MAIN])
    if profiling:
        tracked += phase_profile(torch, droid, frames[N_MAIN:], float(N_MAIN))
    counts_term = phase_terminate(torch, ops, droid, tracked, profiling)
    bucket = droid.cfg.edge_bucket
    n_back = max(r["edges"] for r in droid.backend.fn.runs)
    phase_k1_backend(torch, -(-n_back // bucket) * bucket, droid.video.counter)
    del droid
    counts_prof = phase_profile_frontend(torch, ops)

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
        "corr_build_windows": ("droid_slam_reserch_tpu_torch/csrc/corr_windows_build.cu",
                               "droid_slam_reserch_tpu/ops/pallas_corr.py:715"),
        "corr_lookup_windows": ("droid_slam_reserch_tpu_torch/csrc/corr_windows_lookup.cu",
                                "droid_slam_reserch_tpu/ops/pallas_corr.py:474"),
        "corr_lookup_pmajor": ("droid_slam_reserch_tpu_torch/csrc/corr_pmajor_lookup.cu",
                               "droid_slam_reserch_tpu/ops/pallas_corr.py:109"),
        "corr_extract_windows": ("droid_slam_reserch_tpu_torch/csrc/corr_extract_windows.cu",
                                 "droid_slam_reserch_tpu/ops/pallas_corr.py:391"),
        "corr_build_windows_levels": ("droid_slam_reserch_tpu_torch/csrc/corr_windows_build.cu",
                                      "droid_slam_reserch_tpu/ops/pallas_corr.py:604"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = rows[name]
        # the engine's main path (track, terminate_eva) and this slice's
        # path, the frontend profiler: each path's count, and their sum
        by_path = {"track": counts[name][0], "terminate_eva": counts_term[name][0],
                   "profile_frontend": counts_prof[name][0]}
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": sum(by_path.values()), "launches_by_path": by_path,
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "ops_route": r.get("ops_route", "fp32"),
                        # the lookups' times under a smooth 4-px pan (the others: random
                        # coords); K1's call as a whole, on the device and on the host clock
                        **{k: r[k] for k in ("ms_pan4", "library_ms_pan4", "call_ms", "host_ms")
                           if k in r}})
        if name == "corr_build":     # K2 also at E=1 (motion filter) and EB=64 (backend)
            kernels[-1].update({f"{k}_e1": v for k, v in rows["corr_build_e1"].items()})
            kernels[-1].update({f"{k}_eb64": v for k, v in rows["corr_build_eb64"].items()})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
