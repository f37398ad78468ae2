"""The share of the profiled stretch in which no kernel, copy or memset
ran on the card (the union of their intervals)."""
from port_bench.harness.stats import idle_pct

UNIT, BETTER, LAYER = "%", "lower", "device"


def read(rec):
    t = rec.trace
    return None if t is None else idle_pct(t["busy_s"], t["window_s"])
