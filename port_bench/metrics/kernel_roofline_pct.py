"""The least time K1-K5 could take on their launches in the profiled
stretch (port_bench/harness/roofline.py: operations and bytes the
algorithm needs, at the H100's peaks) over the device time of those
launches, by kernel name.  Silent where a launch went uncounted."""
UNIT, BETTER, LAYER = "%", "higher", "kernels"


def read(rec):
    t = rec.trace
    if t is None:
        return None
    work, calls = t["work"], t["count_kernel"]
    if not work or set(calls) - set(work) or any(calls.get(k, 0) != w[0] for k, w in work.items()):
        return None
    seconds = sum(t["by_kernel"][k] for k in work)
    return 100.0 * sum(w[4] for w in work.values()) / seconds if seconds > 0 else None
