"""Mean synchronised milliseconds of droid.filterx.track per frame of the
window (fnet, cnet, the one-edge K2 + K3 and one update step)."""
UNIT, BETTER, LAYER = "ms", "lower", "motion filter"


def read(rec):
    s = rec.spans.get("motion_filter")
    return 1e3 * sum(s) / len(s) if s else None
