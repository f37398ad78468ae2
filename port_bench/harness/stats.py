"""The arithmetic of the metrics, kept apart so that tests can hold it."""
import math

import torch

# One H100's published peaks (SXM data sheet, dense): fp32 products taken
# as three TF32 products on the tensor cores (495 / 3), other fp32
# arithmetic, and HBM bandwidth.
PEAK_PRODUCTS = 165e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def rate(count, seconds):
    """Work per second over all the work and all the time of the window."""
    return count / seconds


def percentile(values, q):
    """The nearest-rank q-th percentile: the smallest value with at least
    q% of all values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def union_length(intervals):
    """Total length covered by [start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals, lo, hi):
    """The [start, end) stretches of [lo, hi) that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            out.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(a, b) for a, b in out if b > a]


def idle_pct(busy_s, window_s):
    return 100.0 * (1.0 - busy_s / window_s)


def mfu_pct(flops, seconds, peak=PEAK_PRODUCTS):
    return 100.0 * flops / (seconds * peak)


def bound_s(products=0.0, other_ops=0.0, nbytes=0.0):
    """The least time the chip could take: the larger of the operations
    over their peaks and the bytes over the bandwidth."""
    return max(products / PEAK_PRODUCTS + other_ops / PEAK_FP32, nbytes / PEAK_BYTES)


def rel_gap(a, b):
    """||a - b|| / ||b|| in float64; inf where either holds a non-finite value."""
    a = torch.as_tensor(a).double()
    b = torch.as_tensor(b).double()
    if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
        return math.inf
    num, den = float((a - b).norm()), float(b.norm())
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)
