"""Multisession pipeline stages (mirror of multisession/pipeline.py;
reference Euroc_Multisession_Stereo/*).

Every stage works on session state dicts (``Video.state_dict()``'s keys,
numpy), so the stages compose with on-disk npz checkpoints as the
reference's npy bundles do (reference droid.py:92-106, loop_detect.py:
194-240).  Each stage takes ``device`` (default the CUDA card) and builds
every SDroid and Droid there; results come back to the host as numpy.
With ``config.vis_path`` set, only the joint backend's and the fusion's
SDroid stream the live viewer (their terminate stops it): the loop replays
and the evaluation's Droids are built without it, since nothing stops them.
"""
import glob
import os
import re
import shutil

import numpy as np
import torch

from ..engine.droid import Droid, SDroid
from ..eval import evaluate_ate
from .alignment import compute_filtered_mean, estimate_alignment, normalize_transform, transform_poses


def extract_images_by_timestamp(image_dir, tstamps, out_dir, tol=0.5):
    """Export the raw images matching keyframe timestamps — stage 1's
    keyframe image dump (reference loop_detect.py:82-105).

    image_dir: directory of the raw .png frames (EuRoC cam layout);
    tstamps: the video buffer's stored keyframe stamps.  The streams (like
    the reference's, loop_detect.py:79) store ``stride * t`` frame INDICES
    as stamps, and the reference extractor indexes the name-sorted file
    list with them (``sorted_files[idx]``, loop_detect.py:96-105) — so
    integer-valued stamps within range index directly; anything else falls
    back to nearest-timestamp matching within ``tol`` (supports streams
    that carry real ns stamps, e.g. TUM association epochs).
    Returns the copied file list.
    """
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(
        glob.glob(os.path.join(image_dir, "*.png")),
        key=lambda f: int(re.sub(r"\D", "", os.path.basename(f)) or 0),
    )
    stamps = np.array([float(os.path.basename(f)[:-4]) for f in files])
    tstamps = np.asarray(tstamps, np.float64).reshape(-1)
    as_index = np.all(tstamps == np.round(tstamps)) and (
        len(tstamps) == 0 or (tstamps.min() >= 0 and tstamps.max() < len(files))
    )
    copied = []
    for t in tstamps:
        if as_index:
            src = files[int(t)]
        else:
            j = int(np.argmin(np.abs(stamps - t)))
            if abs(stamps[j] - t) > tol * max(1.0, abs(t)):
                continue
            src = files[j]
        dst = os.path.join(out_dir, os.path.basename(src))
        shutil.copy(src, dst)
        copied.append(dst)
    return copied


def run_loop_session(config, params, seed_poses, seed_disps, loop_stream, good=True,
                     device="cuda"):
    """Warm-started "loop" replay session (reference AdjustCoordinates.py:
    149-160): seeded with the first map's poses and disparities, warmup =
    seed length, filter_thresh = -1 and keyframe_thresh = 0 so every loop
    frame is a keyframe; no live viewer.  Returns the SDroid after tracking
    the loop stream's (t, image, ..., intrinsics) items."""
    n_seed = len(seed_poses)
    cfg = config.replace(warmup=n_seed, filter_thresh=-1.0, keyframe_thresh=0.0, good=good,
                         vis_path="")
    droid = SDroid(cfg, params=params, device=device)
    v = droid.video
    v.poses[:n_seed] = torch.tensor(np.asarray(seed_poses, np.float32), device=v.device)
    v.disps[:n_seed] = torch.tensor(np.asarray(seed_disps, np.float32), device=v.device)

    for item in loop_stream:
        t, image, intrinsics = item[0], item[1], item[-1]
        droid.track(t, image, intrinsics=intrinsics)
    return droid


def align_pair(config, params, first_state, second_state, loop_runs, device="cuda"):
    """Stage 2: estimate T aligning map B into map A's frame
    (reference AdjustCoordinates.py:107-236).

    loop_runs: list of (seed_indices, old_indices, loop_stream_factory):
      seed_indices — frames of map A seeding the loop session,
      old_indices — frames of map B matched by the tail of the loop session,
      loop_stream_factory() — iterable of loop images.
    Returns (T [7], transformed_second_poses, rows).
    """
    rows_all = []
    for seed_idx, old_idx, stream_factory in loop_runs:
        droid_loop = run_loop_session(
            config, params, first_state["poses"][seed_idx], first_state["disps"][seed_idx],
            stream_factory(), device=device)
        n_seed = len(seed_idx)
        new_idx = torch.arange(n_seed, n_seed + len(old_idx), device=droid_loop.video.device)
        loop_poses = droid_loop.video.poses[new_idx].cpu().numpy()
        old_poses = second_state["poses"][np.asarray(old_idx)]
        _, rows = estimate_alignment(old_poses, loop_poses)
        rows_all.append(rows)

    rows_all = np.concatenate(rows_all, axis=0)
    T = normalize_transform(compute_filtered_mean(rows_all)).astype(np.float32)
    new_second_poses = transform_poses(T, second_state["poses"], inverse=True)
    return T, new_second_poses, rows_all


def improve_adjust(config, params, first_state, groups, bad_limit=4, probe_frames=80,
                   device="cuda"):
    """Stage 2v2 — the fork's robust map-recovery orchestration
    (reference Euroc_Multisession_Stereo/ImproveAdjust.py:204-337).

    groups: candidate loop groups, each a dict:
      seed_idx:       map-A frame indices seeding the warm-started session
      frame_idx:      the group's matched frame-index list (increasing =
                      forward traversal; decreasing = reverse)
      stream_factory: callable -> iterable of (t, image, intrinsics)

    Per group: (1) PROBE with the confidence gate ON (good=False) over the
    first `probe_frames` frames; if more than `bad_limit` keyframes fail the
    gate the group is rejected (:204-210).  (2) On success, RETRY ungated
    (good=True) over the whole stream, run the double backend, and harvest
    the recovered segment after the seed — reversed when the traversal was
    backwards so both segments end up forward-ordered (:233-249).
    (3) Stop once TWO groups succeed (one forward, one reverse expected) and
    STITCH them — the reverse-traversal segment precedes the forward one
    (:286-311 `good_point==2` ordering).

    Returns (recovered state dict or None, per-group report list).
    """
    report = []
    segments = []  # (is_forward, segment dict)
    for g in groups:
        seed_idx = np.asarray(g["seed_idx"])
        frame_idx = list(g["frame_idx"])
        seed_poses = first_state["poses"][seed_idx]
        seed_disps = first_state["disps"][seed_idx]

        # ---- probe with the gate on (good=False)
        probe = run_loop_session(
            config, params, seed_poses, seed_disps,
            _take(g["stream_factory"](), probe_frames), good=False, device=device,
        )
        n_bad = len(probe.frontend.badT)
        del probe
        if n_bad > bad_limit:
            report.append({"group": g.get("name", len(report)), "bad": n_bad,
                           "accepted": False})
            continue

        # ---- gated probe passed: ungated full replay + double backend
        droid_loop = run_loop_session(
            config, params, seed_poses, seed_disps, g["stream_factory"](),
            good=True, device=device,
        )
        droid_loop.terminate()
        v = droid_loop.video
        n_seed = len(seed_idx)
        stop = min(n_seed + len(frame_idx), int(v.counter))
        seg = {
            "poses": v.poses[n_seed:stop].cpu().numpy(),
            "disps": v.disps[n_seed:stop].cpu().numpy(),
            "images": v.images[n_seed:stop],
            "intrinsics": v.intrinsics[n_seed:stop].cpu().numpy(),
            "tstamp": v.tstamp[n_seed:stop],
        }
        forward = all(x < y for x, y in zip(frame_idx, frame_idx[1:]))
        if not forward:
            seg = {k: val[::-1].copy() for k, val in seg.items()}
        segments.append((forward, seg))
        report.append({"group": g.get("name", len(report)), "bad": n_bad,
                       "accepted": True, "forward": forward})
        del droid_loop
        if len(segments) == 2:
            break

    if len(segments) < 2:
        return None, report

    # stitch: reverse-traversal segment first (reference :286-311)
    segments.sort(key=lambda s: s[0])  # False (reverse) before True (forward)
    a, b = segments[0][1], segments[1][1]
    state = {k: np.concatenate([a[k], b[k]], axis=0) for k in a}
    return state, report


def _take(stream, n):
    for i, item in enumerate(stream):
        if i >= n:
            break
        yield item


def _loaded_sdroid(config, params, states, device):
    """An SDroid whose video holds the states one after another, its buffer
    at least their keyframes plus 8; returns it and each state's slots."""
    total = sum(len(s["poses"]) for s in states)
    cfg = config.replace(buffer=max(config.buffer, _round_up8(total + 8)))
    droid = SDroid(cfg, params=params, device=device)
    off = 0
    bounds = []
    for s in states:
        droid.video.load_state_dict(s, offset=off)
        bounds.append((off, off + len(s["poses"])))
        off += len(s["poses"])
    droid.video.counter = off
    return droid, bounds


def joint_backend(config, params, states, device="cuda"):
    """Concatenate session states into one buffer and run the global backend
    twice (reference AdjustCoordinates.py:219-229, SDroid.terminate).
    Returns per-session refined pose arrays."""
    droid, bounds = _loaded_sdroid(config, params, states, device)
    droid.terminate()
    return [droid.video.poses[a:b].cpu().numpy() for (a, b) in bounds]


def fuse_maps(config, params, states, subsample=2, device="cuda"):
    """Stage 3 (reference BackendAllMaps.py:63-159): subsample every
    `subsample`-th keyframe of each transformed map, concatenate, global BA.
    Returns the fused session state."""
    sub_states = []
    for s in states:
        sel = np.arange(0, len(s["poses"]), subsample)
        sub_states.append({k: np.asarray(v)[sel] for k, v in s.items()})
    droid, _ = _loaded_sdroid(config, params, sub_states, device)
    droid.terminate()
    return droid.video.state_dict()


def evaluate_fused_map(config, params, fused_state, session_slices, streams,
                       gts=None, correct_scale=False, device="cuda"):
    """Stage 4 (reference Whole_Evaluate.py:142-225): per sequence, inject
    the fused map's keyframes into a Droid, fill non-keyframe poses, then
    concatenated ATE vs concatenated groundtruth.

    session_slices: [(start, stop)] ranges of each sequence in the fused map;
    streams: per-sequence callables yielding (t, image, intrinsics);
    gts: optional per-sequence [N, 8] TUM arrays.
    Returns (trajectories, ate dict or None).
    """
    trajs = []
    for (a, b), stream_factory in zip(session_slices, streams):
        sub = {k: np.asarray(v)[a:b] for k, v in fused_state.items()}
        cfg = config.replace(buffer=max(config.buffer, _round_up8(b - a + 64)), vis_path="")
        droid = Droid(cfg, params=params, device=device)
        droid.video.load_state_dict(sub)
        trajs.append(droid.terminate_eva_second(stream_factory()))

    if gts is None:
        return trajs, None

    est_all, gt_all = [], []
    for traj, gt in zip(trajs, gts):
        n = min(len(traj), len(gt))
        est_all.append(np.concatenate([gt[:n, :1], traj[:n, :3], traj[:n, 3:]], 1))
        gt_all.append(gt[:n])
    est_all = np.concatenate(est_all, 0)
    gt_all = np.concatenate(gt_all, 0)
    res = evaluate_ate(est_all, gt_all, align=True, correct_scale=correct_scale)
    return trajs, res


def _round_up8(x):
    return ((x + 7) // 8) * 8
