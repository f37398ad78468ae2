"""The window's seconds over its whole Droid.terminate_eva calls, each
starting from the video restored from set-up's snapshot (restores
included; the check's host copies of each call's output left out)."""
UNIT, BETTER = "s", "lower"


def read(rec):
    return rec.window_s / rec.calls if rec.calls else None
