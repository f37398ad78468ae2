"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference (``port_bench/reference``) fed the same
frames, depths and weights.

Every number is a relative L2 gap, ||program - reference|| / ||reference||.
Two are the same in every cell (``check_tracked``): the reference tracks
set-up's frames through initialisation from scratch, on nothing but the
raw inputs, and the frontend's edge states are compared edge by edge
right after it (``init_net``); each frame that set-up tracks after that
is followed step by step from the program's state (``settle_net``).  The
rest are the loop's own (``port_bench/loops/<loop>.py::check``).

A number over its limit, or one that cannot be read (a non-finite value,
no edge in common), fails the check.  A number with no limit in the cell's
limits file is computed and printed in the run's log, not compared.
"""
import math
import time

import torch

from port_bench.reference import RefDroid, load_networks

from .stats import rel_gap


class Gaps:
    def __init__(self, limits):
        self.limits = limits
        self.worst = {k: 0.0 for k in limits}
        self.unlimited = {}     # numbers worked out but not compared
        self.failed = 0
        self.info = []

    def judge(self, values):
        """One checked answer: its numbers, each kept at its worst."""
        bad = False
        for k, v in values.items():
            v = math.inf if not math.isfinite(v) else v
            if k in self.limits:
                self.worst[k] = max(self.worst[k], v)
                bad |= v > self.limits[k]
            else:
                self.unlimited[k] = max(self.unlimited.get(k, 0.0), v)
        self.failed += int(bad)

    @property
    def correct(self):
        return self.failed == 0 and all(self.worst[k] <= self.limits[k] for k in self.limits)


def changed_from(pre, *posts):
    """First slot whose pose or disparity any of ``posts`` changed from ``pre``."""
    lo = None
    n = len(pre["poses"])
    for post in posts:
        diff = ((post["poses"][:n] != pre["poses"]).any(-1)
                | (post["disps"][:n] != pre["disps"]).flatten(1).any(-1))
        idx = torch.nonzero(diff)
        first = int(idx[0]) if len(idx) else n
        lo = first if lo is None else min(lo, first)
    return lo


def edge_rows(ii, jj):
    return {(int(i), int(j)): k for k, (i, j) in enumerate(zip(ii, jj))}


def net_gap(prog, graph):
    """The edges' hidden states, edge by edge over the (i, j) pairs both
    graphs hold; inf where they share none."""
    rows_p, rows_r = edge_rows(prog["ii"], prog["jj"]), edge_rows(graph.ii, graph.jj)
    common = sorted(set(rows_p) & set(rows_r))
    if not common:
        return math.inf
    return rel_gap(prog["net"][[rows_p[e] for e in common]],
                   graph.net[[rows_r[e] for e in common]].cpu())


def follow_step(nets, cfg, frames, intr, enc, t, pre, device):
    """The reference's ``track`` of frame t from the program's state before
    it (``pre``: ``runner.capture_pre``), with every frame's features,
    sensor disparity and intrinsics its own (``enc``: ``RefDroid.encode``
    of frames 0 .. t or more).  Returns the reference after the step."""
    ref = RefDroid(cfg, nets, device)
    ref.load_frames([float(k) for k in range(t)], [frames.image(k) for k in range(t)],
                    None if frames.depth is None else
                    [frames.depth_map(k) for k in range(t)], [intr] * t,
                    encoded=tuple(x[:t] for x in enc))
    ref.load_state(pre)
    ref.track(float(t), frames.image(t), depth=frames.depth_map(t), intrinsics=intr)
    return ref


def check_tracked(nets, cfg, frames, intr, states, gaps, device):
    """Set-up's tracking (``runner.track_setup``).  The reference tracks
    frames 0 .. warmup - 1 from scratch, on the raw inputs alone, and the
    frontend's edge states are compared edge by edge right after
    initialisation (``init_net``).  Each settle frame is then followed step
    by step from the program's state before it, and the edges' hidden
    states after the step are compared (``settle_net``): tracked on from
    scratch, two fp32 runs drift apart by round-off compounded over the
    frames, on some seeds as far as bf16's (PERF.md)."""
    init = states["init_net"]
    ref = RefDroid(cfg, nets, device)
    for t in range(init["frames"]):
        ref.track(float(t), frames.image(t), depth=frames.depth_map(t), intrinsics=intr)
    gaps.info.append(f"init_net: {len(init['ii'])} edges in the program, "
                     f"{len(ref.frontend.graph.ii)} in the reference after {init['frames']} frames")
    gaps.judge({"init_net": net_gap(init, ref.frontend.graph)})
    steps = states["settle"]
    gaps.info.append(f"set-up's copies of the settle frames' states: {states['capture_s']:.3f} s")
    if not steps:
        return
    del ref
    enc = RefDroid(cfg, nets, device).encode(
        [frames.image(t) for t in range(steps[-1]["frame"] + 1)])
    for s in steps:
        t, post = s["frame"], s["post"]
        ref = follow_step(nets, cfg, frames, intr, enc, t, s["pre"], device)
        g = ref.frontend.graph
        if ref.video.counter != post["counter"]:
            gaps.info.append(f"settle frame {t}: the program keeps {post['counter']} keyframes, "
                             f"the reference {ref.video.counter}")
            gaps.judge({"settle_net": math.inf})
            continue
        rows_p, rows_r = edge_rows(post["ii"], post["jj"]), edge_rows(g.ii, g.jj)
        gap = net_gap(post, g)
        gaps.info.append(f"settle frame {t}: {len(rows_p)} edges in the program, {len(rows_r)} "
                         f"in the reference, {len(set(rows_p) ^ set(rows_r))} differ; "
                         f"settle_net {gap!r}")
        gaps.judge({"settle_net": gap})


def run_check(loop, params, cfg, frames, intr, rec, limits, device):
    """All of a run's comparisons; returns (Gaps, seconds taken)."""
    t0 = time.perf_counter()
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        nets = load_networks(params, device)
        gaps = Gaps(limits)
        with torch.no_grad():
            check_tracked(nets, cfg, frames, intr, rec["states"], gaps, device)
            loop.check(nets, cfg, frames, intr, rec, gaps, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    gaps.info += [f"not compared: {k} {v!r}" for k, v in gaps.unlimited.items()]
    return gaps, time.perf_counter() - t0
