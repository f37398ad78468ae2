"""The port's engine tracer: spans, counters and capability notices.

One Droid run on the CPU (tests/test_engine's 64x96 configuration, 7
frames, every frame a keyframe) with the tracer switched on by
``timing.enable()``, DROID_TIMING set for the summary and BA sharding
asked for, ended by ``terminate_eva`` over the tracked frames: each span is
opened at the JAX package's sites and under its names (and at the port's
own), with its parent and its request; every blocking host read of the
tracking and terminate paths is counted by site; the update operator's
real and padded edges are counted; ``terminate_eva`` prints the summary;
and the sharded BA and refresh run with no notice (a window too small for
its shards is declined with one).  Switched off, a section records nothing
and touches neither CUDA events nor the profiler.
"""
import collections
import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu_torch.engine import Droid as TDroid
from droid_slam_reserch_tpu_torch.engine import factor_graph as tfg
from droid_slam_reserch_tpu_torch.utils import log as tlog
from droid_slam_reserch_tpu_torch.utils import timing
from test_engine import INTR, synth_frame
from test_torch_engine import torch_config

torch.set_num_threads(1)
N_FRAMES = 7
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the parent each span has where the engine opens it (None: a root)
PARENTS = {
    "track": {None}, "terminate": {None},
    "motion_filter.track": {"track"}, "frontend": {"track"},
    "backend": {"terminate"}, "filler": {"terminate"},
    "upload": {"motion_filter.track", "filler"},
    "encode": {"motion_filter.track", "filler"},
    "select": {"frontend", "backend"},
    "update_fused.setup": {"frontend", "filler"},
    "update_fused.device": {"frontend", "filler"},
    "refresh": {"backend"},
    "corr": {"motion_filter.track", "update_fused.device", "refresh"},
    "update_op": {"motion_filter.track", "update_fused.device", "refresh"},
    "ba": {"update_fused.device", "video.ba"},
    "video.ba": {"backend"},
}


def _section_names(package):
    names = set()
    for root, _, files in os.walk(os.path.join(REPO, package)):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    names |= set(re.findall(r'section\("([^"]+)"\)', fh.read()))
    return names


@pytest.fixture(scope="module")
def run():
    """Track N_FRAMES, then terminate_eva over them.  Returns the Droid, the
    spans, the counters after tracking and after terminate_eva, each
    update_fused call's (n, n_pad, rounds, edges counted, slots counted), the
    motion filter's counted edges and slots, and the output."""
    timing.reset()
    timing.enable()
    out, err = io.StringIO(), io.StringIO()
    d = TDroid(torch_config(ba_shards=2, refresh_shards=2), device="cpu")
    fused, filtered = [], []
    update_fused = tfg.FactorGraph.update_fused

    def counted(graph, rounds, *a, **k):
        before = timing.counters()
        n_pad = tfg._round_up(max(len(graph.ii), 1), graph.cfg.edge_bucket)
        n = len(graph.ii)
        res = update_fused(graph, rounds, *a, **k)
        after = timing.counters()
        fused.append((n, n_pad, rounds, after["edges"] - before.get("edges", 0),
                      after["edge_slots"] - before.get("edge_slots", 0)))
        return res

    filter_track = d.filterx.track

    def filter_counted(*a, **k):
        before = timing.counters()
        filter_track(*a, **k)
        after = timing.counters()
        filtered.append(tuple(after.get(c, 0) - before.get(c, 0)
                              for c in ("edges", "edge_slots")))

    d.filterx.track = filter_counted
    os.environ["DROID_TIMING"] = "1"
    tfg.FactorGraph.update_fused = counted
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rng = np.random.RandomState(0)
            frames = [synth_frame(t, rng) for t in range(N_FRAMES)]
            for t, img in enumerate(frames):
                d.track(float(t), img, intrinsics=INTR)
            after_track = timing.counters()
            d.terminate_eva([(float(t), img, INTR) for t, img in enumerate(frames)])
    finally:
        tfg.FactorGraph.update_fused = update_fused
        del os.environ["DROID_TIMING"]
        timing.disable()
    spans = timing.spans()
    counters = timing.counters()
    timing.reset()
    return (d, spans, after_track, counters, fused, filtered, out.getvalue(), err.getvalue())


def test_sections_at_the_jax_sites(run):
    d, spans, _, _, _, _, _, _ = run
    counts = collections.Counter(s["name"] for s in spans)
    assert set(counts) == _section_names("droid_slam_reserch_tpu_torch")
    assert counts["track"] == counts["motion_filter.track"] == counts["frontend"] == N_FRAMES
    assert counts["backend"] == 2 and counts["terminate"] == counts["filler"] == 1
    assert counts["update_fused.device"] == counts["update_fused.setup"] > 0
    assert counts["video.ba"] > 0
    assert all(s["t1_ns"] >= s["t0_ns"] and s["device_ms"] is None for s in spans)


def test_section_names_match_the_jax_package():
    assert _section_names("droid_slam_reserch_tpu_torch") == set(timing.SPANS)
    assert len(set(timing.SPANS)) == len(timing.SPANS)
    assert _section_names("droid_slam_reserch_tpu") - {"update_fused.sync"} <= set(timing.SPANS)


def test_each_span_has_its_parent_and_request(run):
    _, spans, _, _, _, _, _, _ = run
    for s in spans:
        parent = None if s["parent"] is None else spans[s["parent"]]
        assert (parent and parent["name"]) in PARENTS[s["name"]], s
        if parent is not None:
            assert parent["t0_ns"] <= s["t0_ns"] and s["t1_ns"] <= parent["t1_ns"]
            assert s["request"] == parent["request"]
    # the frame's timestamp while tracking, the call's ordinal under terminate
    roots = [(s["name"], s["request"]) for s in spans if s["parent"] is None]
    assert roots == [("track", float(t)) for t in range(N_FRAMES)] + [("terminate", 0)]


def test_host_syncs_counted(run):
    d, _, track, total, _, _, _, _ = run
    assert d.video.counter == N_FRAMES
    # admission of frames 1-6, the culling decisions of frames 5 and 6, and
    # the proximity selections of the initialisation and those two updates
    sites = ("admission", "cull", "select")
    assert sum(track.get("host_syncs." + k, 0) for k in sites) == (N_FRAMES - 1) + 2 + 3
    # each backend run selects its edges by proximity once and (mono) reads
    # the sensor disparities once; the filler reads its one chunk's poses
    assert total["host_syncs.select"] == track["host_syncs.select"] + 2
    assert total["host_syncs.normalize"] == 2 and total["host_syncs.filler"] == 1
    # every round of update_fused reads its drift rule once
    assert total["host_syncs.drift"] == total.get("corr_rounds.windowed", 0) + \
        total.get("corr_rounds.fallback", 0) > 0
    assert tfg.corr_rounds() == {"windowed": 0, "fallback": 0}     # after reset()
    assert total["host_syncs"] == sum(v for k, v in total.items()
                                      if k.startswith("host_syncs."))
    assert set(k for k in total if k.startswith("host_syncs.")) <= {
        "host_syncs." + k for k in ("admission", "cull", "select", "drift", "filler",
                                    "quality", "edge_filter", "normalize")}


def test_edges_and_slots_counted(run):
    _, _, _, total, fused, filtered, _, _ = run
    assert fused and all(e == r * n and s == r * n_pad for n, n_pad, r, e, s in fused)
    assert all(n <= n_pad for n, n_pad, _, _, _ in fused)
    # the motion filter's one-edge check on every frame after the first
    assert filtered == [(0, 0)] + [(1, 1)] * (N_FRAMES - 1)
    assert total["edges"] < total["edge_slots"]
    assert total["keyframes"] == N_FRAMES and total["ba_iterations"] > 0


def test_terminate_prints_the_summary(run):
    _, spans, _, total, _, _, out, _ = run
    assert "=== droid timings ===" in out
    for name, c in collections.Counter(s["name"] for s in spans).items():
        assert re.search(rf"^{re.escape(name)}\s+total .* calls\s+{c}\s+avg .* device\s+-s$",
                         out, re.M)
    assert re.search(rf"^host_syncs\s+count {total['host_syncs']}$", out, re.M)


def test_disabled_section_touches_nothing(monkeypatch):
    """Off, a section is one shared no-op: no span, no CUDA event, no
    profiler range; on (with CUDA taken as initialised), each span makes
    its two events, opens its range and reads its device time once the end
    event has completed."""
    made = collections.Counter()

    class Event:
        def __init__(self, enable_timing=False):
            made["event"] += 1

        def record(self):
            made["record"] += 1

        def query(self):
            return True

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return 2.5

    real_range = torch.profiler.record_function

    def record_function(name):
        made["range"] += 1
        return real_range(name)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    timing.reset()
    timing.disable()
    assert timing.section("corr") is timing.section("ba")
    with timing.section("frontend"):
        with timing.section("corr"):
            pass
    assert timing.spans() == [] and not made
    timing.enable()
    try:
        with timing.section("frontend"):
            with timing.section("corr"):
                pass
    finally:
        timing.disable()
    assert made == {"event": 4, "record": 4, "range": 2}
    spans = timing.spans()
    timing.reset()
    assert [(s["name"], s["parent"], s["device_ms"]) for s in spans] == [
        ("frontend", None, 2.5), ("corr", 0, 2.5)]


def test_sharding_declined_once_each(run):
    """ba_shards=2 and refresh_shards=2 shard (parallel/) and print no
    notice, as the JAX package prints none for windows that hold the shards;
    a window smaller than ba_shards is declined with one notice."""
    d, _, _, _, _, _, _, err = run
    assert not [ln for ln in err.splitlines() if ln.startswith("[droid-tpu]")]
    v = d.video
    v.cfg = v.cfg.replace(ba_shards=24)
    tlog._seen.discard("ba_shard_decline_16_24")      # once per process: forget other tests'
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert [v._resolved_ba_shards(16, False) for _ in range(2)] == [0, 0]
        assert v._resolved_ba_shards(16, True) == 0           # motion-only: no notice
    lines = err.getvalue().splitlines()
    assert lines == ["[droid-tpu] BA sharding declined: window MW=16 < ba_shards=24"]
