"""The 90th percentile (nearest rank) over every frame of the window of the
time from handing the frame to Droid.track to its return after a
synchronise."""
from port_bench.harness.stats import percentile

UNIT, BETTER = "ms", "lower"


def read(rec):
    return 1e3 * percentile(rec.latencies, 90) if rec.latencies else None
