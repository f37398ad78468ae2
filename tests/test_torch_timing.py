"""The port's engine timings, host-sync count and capability notices.

One Droid run on the CPU (tests/test_engine's 64x96 configuration, 7
frames, every frame a keyframe) with DROID_TIMING set and BA sharding asked
for: each engine section is timed at the JAX package's sites and under its
names, every blocking host read of the tracking path is counted,
``terminate`` prints the summary, and the sharded BA and refresh run with
no notice (a window too small for its shards is declined with one).
"""
import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu_torch.engine import Droid as TDroid
from droid_slam_reserch_tpu_torch.utils import log as tlog
from droid_slam_reserch_tpu_torch.utils import timing
from test_engine import INTR, synth_frame
from test_torch_engine import torch_config

torch.set_num_threads(1)
N_FRAMES = 7
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    timing.GLOBAL_TIMINGS.totals.clear()
    timing.GLOBAL_TIMINGS.counts.clear()
    timing.SYNC_COUNT[0] = 0
    out, err = io.StringIO(), io.StringIO()
    d = TDroid(torch_config(ba_shards=2, refresh_shards=2), device="cpu")
    os.environ["DROID_TIMING"] = "1"
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rng = np.random.RandomState(0)
            for t in range(N_FRAMES):
                d.track(float(t), synth_frame(t, rng), intrinsics=INTR)
            syncs_track = timing.SYNC_COUNT[0]
            d.terminate()
    finally:
        del os.environ["DROID_TIMING"]
    return d, dict(timing.GLOBAL_TIMINGS.counts), syncs_track, out.getvalue(), err.getvalue()


def test_sections_at_the_jax_sites(run):
    d, counts, _, _, _ = run
    assert set(counts) == _section_names("droid_slam_reserch_tpu_torch")
    assert counts["motion_filter.track"] == counts["frontend"] == N_FRAMES
    assert counts["backend"] == 2
    assert counts["update_fused.sync"] == counts["update_fused.device"] > 0
    assert counts["video.ba"] > 0


def test_section_names_match_the_jax_package():
    assert _section_names("droid_slam_reserch_tpu_torch") == _section_names("droid_slam_reserch_tpu")


def test_host_syncs_counted(run):
    d, _, syncs_track, _, _ = run
    assert d.video.counter == N_FRAMES
    # admission of frames 1-6, the culling decisions of frames 5 and 6, and
    # the proximity selections of the initialisation and those two updates
    assert syncs_track == (N_FRAMES - 1) + 2 + 3
    # each backend run selects its edges by proximity once
    assert timing.SYNC_COUNT[0] == syncs_track + 2


def test_terminate_prints_the_summary(run):
    _, counts, _, out, _ = run
    assert "=== droid timings ===" in out
    for name in counts:
        assert re.search(rf"^{re.escape(name)}\s+total .* calls\s+{counts[name]}\s", out, re.M)


def test_sharding_declined_once_each(run):
    """ba_shards=2 and refresh_shards=2 shard (parallel/) and print no
    notice, as the JAX package prints none for windows that hold the shards;
    a window smaller than ba_shards is declined with one notice."""
    d, _, _, _, err = run
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
