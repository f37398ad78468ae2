"""Lightweight timers (copy of the JAX package's utils/timing.py)."""
import time
from collections import defaultdict
from contextlib import contextmanager


class Timings:
    """Accumulates named wall-clock sections; print with summary()."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def section(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self):
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:32s} total {t:8.3f}s  calls {c:6d}  avg {1000*t/max(c,1):8.2f}ms")
        return "\n".join(lines)


class Timer:
    """Wall-clock seconds since construction."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def elapsed(self):
        return time.perf_counter() - self.t0


# process-wide timings for the SLAM engine sections (motion filter, frontend,
# backend, BA).  Enable the summary dump with DROID_TIMING=1; section() is a
# no-op-cost context manager either way.
GLOBAL_TIMINGS = Timings()


def section(name):
    return GLOBAL_TIMINGS.section(name)


def maybe_report():
    import os

    if os.environ.get("DROID_TIMING"):
        print("=== droid timings ===")
        print(GLOBAL_TIMINGS.summary(), flush=True)


# count of BLOCKING host<->device syncs on the tracking path (keyframe
# admission, culling decision, proximity matrices); chip_smoke.py's cli
# phase prints it per command, as the JAX package's tools/bench_e2e.py does.
SYNC_COUNT = [0]


def count_sync():
    SYNC_COUNT[0] += 1
