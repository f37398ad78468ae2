"""Device milliseconds per unit of the window's work (a frame, or a
terminate_eva call) of the kernels launched inside the update operator's
forward (net.update), from the profiled stretch."""
UNIT, BETTER, LAYER = "ms", "lower", "model"


def read(rec):
    t = rec.trace
    if t is None or not t["units"] or "update_op" not in t["in_range"]:
        return None
    return 1e3 * t["in_range"]["update_op"] / t["units"]
