"""Loop ``stream``: the reference's evaluation loop, ``Droid.track`` frame
after frame, as a closed loop (the next frame is handed over once the last
one's ``track`` has returned and the device has finished), for
``--seconds``.

Set-up tracks through initialisation and ``settle_frames`` more, so that
the frontend's graph has reached its working size
(``harness/runner.py::track_setup``, checked by
``harness/check.py::check_tracked``).  In the window,
``checked_steps`` frames are checked step by step: the first frame handed
over after each of as many moments drawn from the seed over the whole
window.  The program's state is copied to the host before and after them,
off the window's clock.

Parameters (the traffic file): ``settle_frames``, ``checked_steps``,
``trace_seconds`` and the frame generator's (``harness/inputs.py``).
"""
import math
import time

import numpy as np

from port_bench.harness.check import changed_from, edge_rows, follow_step, net_gap
from port_bench.harness.runner import capture_post, capture_pre, sync, track_setup
from port_bench.harness.stats import rel_gap
from port_bench.reference import RefDroid


def frames_needed(cfg, mix):
    """Every slot of the video but the last: the window stops with an
    error rather than wrap it."""
    return cfg.buffer - 1


def run(runner, seed, seconds, cfg):
    """Set-up, window and captures.  Returns what the record and the check read."""
    mix, d, dev = runner.mix, runner.droid, runner.device
    max_frames = frames_needed(cfg, mix)
    t, states = track_setup(runner, cfg)
    due = sorted(np.random.default_rng([seed, 2]).uniform(
        0.0, seconds, int(mix["checked_steps"])).tolist())

    steps, lat = [], []
    setup_end = time.perf_counter()
    runner.open_window()
    frames_done = window_s = None
    peak = k = lost = 0
    while frames_done is None or due:
        if t >= max_frames:
            if not lost:
                raise RuntimeError(f"the window reached frame {t}, the video's last slot: "
                                   "raise the configuration's buffer before tracking this fast")
            if frames_done is None:     # frames were lost: the check fails the run
                frames_done = k
                window_s, peak = runner.close_window(k)
            break
        checked = bool(due) and (frames_done is not None or runner.elapsed() >= due[0])
        pre = runner.aside(capture_pre, d) if checked else None
        a = time.perf_counter()
        runner.track(t)
        sync(dev)
        b = time.perf_counter()
        if frames_done is None:
            lat.append(b - a)
        if pre is not None:
            due.pop(0)
            post = runner.aside(capture_post, d, pre["counter"])
            steps.append({"frame": t, "in_window": frames_done is None, "pre": pre,
                          "post": post})
        lost += d.video.counter != t + 1     # the configuration keeps every frame
        t += 1
        k += 1
        if frames_done is None:
            runner.tick(k)
            if runner.elapsed() >= seconds:
                frames_done = k
                window_s, peak = runner.close_window(k)
    return {"setup_end": setup_end, "window_s": window_s, "peak_bytes": peak,
            "attempted": frames_done, "record": {"frames": frames_done, "latencies": lat},
            "states": states, "steps": steps, "lost": lost,
            "spans": dict(runner.spans.seconds)}


def check(nets, cfg, frames, intr, rec, gaps, device):
    """At each checked frame the reference follows the program step by step
    from the program's state before it, working out every frame's features,
    sensor disparity and intrinsics itself: ``feat`` the new frame's fnet and
    cnet outputs (the worst of fmaps, net, inp); ``net`` the edges' hidden
    states after the update operator's rounds, edge by edge; ``pose`` and
    ``disp`` the keyframes the step moved."""
    if rec["lost"]:
        gaps.info.append(f"{rec['lost']} frames of the window left no keyframe")
        gaps.judge({"pose": math.inf})
    steps = rec["steps"]
    if not steps:
        return
    last = max(s["frame"] for s in steps)
    enc = RefDroid(cfg, nets, device).encode([frames.image(t) for t in range(last + 1)])
    for s in steps:
        t, pre, post = s["frame"], s["pre"], s["post"]
        ref = follow_step(nets, cfg, frames, intr, enc, t, pre, device)
        v, g = ref.video, ref.frontend.graph
        n = v.counter + 1
        out = {"poses": v.poses[:n].cpu(), "disps": v.disps[:n].cpu()}
        if v.counter != post["counter"]:
            gaps.info.append(f"frame {t}: the program keeps {post['counter']} keyframes, "
                             f"the reference {v.counter}")
            gaps.judge({"pose": math.inf})
            continue
        lo = changed_from(pre, post, out)
        rows_p, rows_r = edge_rows(post["ii"], post["jj"]), edge_rows(g.ii, g.jj)
        where = "in the window" if s["in_window"] else "after the window"
        gaps.info.append(f"frame {t} ({where}): {len(rows_p)} edges in the program, "
                         f"{len(rows_r)} in the reference, {len(set(rows_p) ^ set(rows_r))} "
                         f"differ; keyframes {lo}..{n - 1} moved")
        feat = max(rel_gap(post[k], getattr(v, k)[t].reshape(post[k].shape).cpu())
                   for k in ("fmaps", "nets", "inps"))
        gaps.judge({"feat": feat, "net": net_gap(post, g),
                    "pose": rel_gap(post["poses"][lo:n], out["poses"][lo:n]),
                    "disp": rel_gap(post["disps"][lo:n], out["disps"][lo:n])})

