"""The metric arithmetic: the rate over all frames and all time, p90 over
all frames, the idle share from interval unions, mfu, and the readers."""
import math

import pytest
import torch

from port_bench.harness import Record, stats
from port_bench.harness.cells import load_reader


def test_rate_and_nearest_rank_percentile():
    assert stats.rate(120, 48.0) == 2.5
    lat = [0.4] * 89 + [0.5] + [0.9] * 10       # 100 frames
    assert stats.percentile(lat, 90) == 0.5
    assert stats.percentile(list(range(1, 11)), 90) == 9
    assert stats.percentile([3.0], 90) == 3.0
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_union_gaps_and_idle_share():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.8), (9.0, 12.0)]
    assert stats.union_length(iv) == 7.0
    assert stats.gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]
    assert stats.gaps([], 0.0, 1.0) == [(0.0, 1.0)]
    assert stats.idle_pct(7.0, 10.0) == pytest.approx(30.0)


def test_mfu_and_bound():
    assert stats.mfu_pct(165e12 * 0.5, 10.0) == pytest.approx(5.0)
    assert stats.bound_s(products=165e12) == pytest.approx(1.0)
    assert stats.bound_s(other_ops=67e12, nbytes=3.35e12 * 0.5) == pytest.approx(1.0)
    assert stats.bound_s(nbytes=3.35e12 * 2) == pytest.approx(2.0)


def test_rel_gap_is_infinite_on_non_finite_values():
    b = torch.ones(4)
    assert stats.rel_gap(b * 1.01, b) == pytest.approx(0.01)
    assert math.isinf(stats.rel_gap(torch.tensor([float("nan"), 1.0]), torch.ones(2)))
    assert stats.rel_gap(torch.zeros(3), torch.zeros(3)) == 0.0


def _trace():
    return {"busy_s": 9.0, "window_s": 10.0, "units": 20,
            "in_range": {"update_op": 4.0}, "conv_flops": 165e12,
            "by_kernel": {"K1": 0.5, "K2": 0.5},
            "count_kernel": {"K1": 3, "K2": 1},
            "work": {"K1": (3, 0.0, 1.0, 1.0, 0.25), "K2": (1, 165e12, 0.0, 0.0, 0.25)}}


def test_readers_on_a_record():
    rec = Record(frames=100, latencies=[0.4] * 90 + [0.6] * 10, window_s=40.0,
                 setup_s=21.5, peak_bytes=2 ** 31, trace=_trace(),
                 spans={"motion_filter": [0.02, 0.04], "frontend": [0.3, 0.5]})
    read = {n: load_reader(n).read(rec) for n in (
        "frames_per_s", "frame_latency_p90_ms", "terminate_s", "peak_mem_gib", "setup_s",
        "motion_filter_ms.stream", "frontend_ms.stream", "update_op_device_ms.stream",
        "kernel_roofline_pct.stream", "mfu.stream", "device_idle_pct.stream", "mfu.backend")}
    assert read["frames_per_s"] == 2.5 and read["frame_latency_p90_ms"] == pytest.approx(400.0)
    assert read["terminate_s"] is None and read["mfu.backend"] == read["mfu.stream"]
    assert read["peak_mem_gib"] == 2.0 and read["setup_s"] == 21.5
    assert read["motion_filter_ms.stream"] == pytest.approx(30.0)
    assert read["frontend_ms.stream"] == pytest.approx(400.0)
    assert read["update_op_device_ms.stream"] == pytest.approx(200.0)
    assert read["kernel_roofline_pct.stream"] == pytest.approx(50.0)
    assert read["mfu.stream"] == pytest.approx(20.0)        # (165e12 + 165e12) / (10 s * 165e12)
    assert read["device_idle_pct.stream"] == pytest.approx(10.0)


def test_roofline_is_silent_when_a_launch_went_uncounted():
    t = _trace()
    t["count_kernel"] = {"K1": 4, "K2": 1}
    rec = Record(trace=t)
    assert load_reader("kernel_roofline_pct.stream").read(rec) is None
    t["count_kernel"] = {"K1": 3, "K2": 1, "K3": 2}
    assert load_reader("kernel_roofline_pct.stream").read(rec) is None


def test_terminate_readers():
    rec = Record(calls=6, window_s=48.0, spans={"backend": [6.0, 7.0], "filler": [0.8, 1.0]})
    assert load_reader("terminate_s").read(rec) == 8.0
    assert load_reader("frames_per_s").read(rec) is None
    assert load_reader("backend_s.backend").read(rec) == 6.5
    assert load_reader("filler_s.backend").read(rec) == pytest.approx(0.9)
