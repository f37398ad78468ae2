"""Frames whose Droid.track returned (synchronised) in the window, over the
window's seconds (the check's host copies left out of both)."""
from port_bench.harness.stats import rate

UNIT, BETTER = "frames/s", "higher"


def read(rec):
    return None if rec.frames is None else rate(rec.frames, rec.window_s)
