"""What a ``--trace 1`` run reads around the program, from the benchmark's
own files: wrappers around the entry points of K1-K5 (shapes, and so the
least time each call could take), forward hooks that count every
``nn.Conv2d``'s operations, a profiler range around each call of the
update operator, and the reduction of ``torch.profiler``'s trace to busy
time, idle gaps, kernel times and per-range device time.

Nothing inside the program is edited: the wrappers replace the names
that the engine's modules imported, for the length of the run.
"""
import collections
import json
import os
import re
import tempfile

import torch

from . import roofline, stats

SPAN_PREFIX = "port_bench."
# kernel -> the names its CUDA kernels carry in a trace (fp32 and bf16)
KERNEL_NAMES = {
    "K1": ("ba_blocks_kernel",),
    "K2": ("corr_build_kernel", "corr_build_bf16_kernel"),
    "K3": ("corr_lookup_kernel", "corr_lookup_bf16_kernel"),
    "K4": ("windows_build_kernel", "windows_build_bf16_kernel"),
    "K5": ("windows_lookup_kernel", "windows_lookup_bf16_kernel"),
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_of(name):
    """K1-K5 for a device kernel's name in a trace, else None."""
    for k, names in KERNEL_NAMES.items():
        for n in names:
            if re.search(rf"(?<![A-Za-z0-9_]){n}(?![A-Za-z0-9_])", name):
                return k
    return None


class Probe:
    """Counts while ``active``: K1-K5 calls with their shapes, conv
    operations, and the update operator's profiler ranges."""

    def __init__(self):
        self.active = False
        self.calls = collections.defaultdict(list)   # kernel -> [(bound args | deferred)]
        self.conv_flops = 0.0
        self._undo = []

    # -- installing
    def install(self, droid):
        from droid_slam_reserch_tpu_torch.ba import solver
        from droid_slam_reserch_tpu_torch.engine import factor_graph, motion_filter

        for mod in (factor_graph, motion_filter):
            for name in ("corr_build", "corr_lookup", "corr_build_windows",
                         "corr_lookup_windows"):
                if hasattr(mod, name):
                    self._patch(mod, name, getattr(self, "_" + name)(getattr(mod, name)))
        kw = solver.ba_iterations.__kwdefaults__
        old = kw["blocks"]
        kw["blocks"] = self._ba_blocks(old)
        self._undo.append(lambda: kw.__setitem__("blocks", old))

        for m in droid.net.modules():
            if isinstance(m, torch.nn.Conv2d):
                h = m.register_forward_hook(self._conv_hook)
                self._undo.append(h.remove)
        update = droid.net.update
        fwd = update.forward

        def ranged(*a, **k):
            with torch.profiler.record_function(SPAN_PREFIX + "update_op"):
                return fwd(*a, **k)

        update.forward = ranged
        self._undo.append(lambda: delattr(update, "forward"))

    def uninstall(self):
        while self._undo:
            self._undo.pop()()

    def _patch(self, mod, name, fn):
        old = getattr(mod, name)
        setattr(mod, name, fn)
        self._undo.append(lambda: setattr(mod, name, old))

    def _conv_hook(self, module, inp, out):
        if self.active:
            self.conv_flops += roofline.conv_flops(module, inp[0], out)

    # -- the wrappers
    def _ba_blocks(self, fn):
        def wrapped(target, weight, poses, disps, intrinsics, ii, jj, **kw):
            out = fn(target, weight, poses, disps, intrinsics, ii, jj, **kw)
            N, H, W, _ = target.shape
            if self.active and N * H * W > 0:       # an empty call launches no kernel
                self.calls["K1"].append(roofline.ba_blocks(N, H * W, poses.shape[0]))
            return out
        return wrapped

    def _corr_build(self, fn):
        def wrapped(f1, f2, out_dtype=None):
            levels = fn(f1, f2, out_dtype)
            E, h1, w1, C = f1.shape
            h2, w2 = f2.shape[1:3]
            if self.active and E * h1 * w1 * h2 * w2 > 0:
                self.calls["K2"].append(roofline.corr_build(
                    E, h1, w1, h2, w2, C, f1.element_size(), levels[0].element_size()))
            return levels
        return wrapped

    def _corr_lookup(self, fn):
        def wrapped(levels, coords):
            out = fn(levels, coords)
            E, P = coords.shape[:2]
            if self.active and E * P > 0:
                h2, w2 = levels[0].shape[-2:]
                elt, oelt = levels[0].element_size(), out.element_size()
                self.calls["K3"].append(lambda: roofline.corr_lookup(
                    E, P, roofline.span_cells(coords, h2, w2), elt, oelt))
            return out
        return wrapped

    def _corr_build_windows(self, fn):
        def wrapped(f1, f2, coords0):
            wins, bases = fn(f1, f2, coords0)
            E, h1, w1, C = f1.shape
            h2, w2 = f2.shape[1:3]
            if self.active and E * h1 * w1 * h2 * w2 > 0:
                elt = f1.element_size()
                self.calls["K4"].append(lambda: roofline.corr_build_windows(
                    E, h1, w1, h2, w2, C, roofline.window_cells(bases, h2, w2), elt))
            return wins, bases
        return wrapped

    def _corr_lookup_windows(self, fn):
        def wrapped(wins, bases, coords, target_hw):
            out = fn(wins, bases, coords, target_hw)
            E, P = coords.shape[:2]
            if self.active and E * P > 0:
                self.calls["K5"].append(roofline.corr_lookup_windows(E, P, wins.element_size()))
            return out
        return wrapped

    # -- after the profiled stretch
    def kernel_work(self):
        """kernel -> (calls, products, other operations, bytes, bound seconds)."""
        out = {}
        for k, calls in self.calls.items():
            works = [c() if callable(c) else c for c in calls]
            products = sum(w[0] for w in works)
            out[k] = (len(works), products, sum(w[1] for w in works), sum(w[2] for w in works),
                      sum(stats.bound_s(*w) for w in works))
        return out


def read_trace(path):
    """Reduce a chrome trace of torch.profiler to what the readers need."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, launches, ranges = [], {}, collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, e.get("name", ""), (e.get("args") or {}).get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIX):
            ranges[e["name"][len(SPAN_PREFIX):]].append((ts, ts + dur))
    return device, launches, ranges


def summarize(device, launches, ranges):
    """busy and window seconds, device seconds by kernel name and by K1-K5,
    launch counts of K1-K5, device seconds of the kernels launched inside
    each range, and the idle gaps by the range open at their start."""
    (w0, w1), = ranges["window"]
    inside = [(max(a, w0), min(b, w1), n, c) for a, b, n, c in device if b > w0 and a < w1]
    # the check's copies of the program's state are the harness's work: out of the stretch
    caps = sorted(ranges.get("capture", []))
    cap_starts = [s for s, _ in caps]

    def in_capture(t):
        i = _last_at_or_before(cap_starts, t)
        return i >= 0 and caps[i][0] <= t <= caps[i][1]

    inside = [x for x in inside if not in_capture(launches.get(x[3], -1.0))]
    window = (w1 - w0) - sum(e - s for s, e in caps)
    intervals = [(a, b) for a, b, _, _ in inside]
    busy = stats.union_length(intervals) * 1e-6
    by_name = collections.Counter()
    by_kernel, count_kernel = collections.Counter(), collections.Counter()
    for a, b, name, _ in inside:
        by_name[name] += (b - a) * 1e-6
        k = kernel_of(name)
        if k:
            by_kernel[k] += (b - a) * 1e-6
            count_kernel[k] += 1
    in_range = collections.Counter()
    for rname, spans in ranges.items():
        if rname == "window":
            continue
        spans = sorted(spans)
        starts = [s for s, _ in spans]
        for a, b, _, corr in inside:
            t = launches.get(corr)
            if t is None:
                continue
            i = _last_at_or_before(starts, t)
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                in_range[rname] += (b - a) * 1e-6
    idle = collections.Counter()
    host_spans = sorted((s, e, n) for n, sp in ranges.items()
                        if n not in ("window", "update_op") for s, e in sp)
    for a, b in stats.gaps(intervals, w0, w1):
        span = _open_at(host_spans, a)
        if span != "capture":
            idle[span] += (b - a) * 1e-6
    return {"busy_s": busy, "window_s": window * 1e-6, "by_name": by_name,
            "by_kernel": by_kernel, "count_kernel": count_kernel, "in_range": in_range,
            "idle": idle}


def _last_at_or_before(xs, t):
    lo, hi = 0, len(xs)
    while lo < hi:
        mid = (lo + hi) // 2
        if xs[mid] <= t:
            lo = mid + 1
        else:
            hi = mid
    return lo - 1


def _open_at(spans, t):
    """The innermost (latest-starting) host span open at time t, or 'harness'."""
    best = "harness"
    for s, e, n in spans:
        if s > t:
            break
        if e >= t:
            best = n
    return best


class Profiled:
    """torch.profiler over a stretch of the window, marked as the range
    ``port_bench.window``; ``reduce()``, called once the window has closed,
    reduces its trace."""

    def __init__(self, probe, device):
        self.probe, self.device = probe, torch.device(device)
        self.prof = None
        self.running = False

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.probe.active = self.running = True
        self._range = torch.profiler.record_function(SPAN_PREFIX + "window")
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._range.__exit__(None, None, None)
        self.probe.active = self.running = False
        self.prof.__exit__(*exc)
        return False

    def reduce(self):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            return summarize(*read_trace(path))
        finally:
            os.remove(path)
            self.prof = None
