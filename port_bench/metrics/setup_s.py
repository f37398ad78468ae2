"""Process start to the window's start: imports, the build or load of the
kernels, weights, frames, the set-up's own tracking and warm call."""
UNIT, BETTER = "s", "lower"


def read(rec):
    return rec.setup_s
