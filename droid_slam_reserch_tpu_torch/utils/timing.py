"""The engine's tracer: named spans and counters in one registry (the JAX
package's utils/timing.py, extended).

``section(name)`` is the one entry point at every site.  Off (the default)
it returns one shared no-op context: it reads no clock, makes no CUDA event
and opens no profiler range.  On (``enable()``, or ``DROID_TIMING`` set in
the environment when this module is imported) each span records its name,
its parent (the innermost span open when it starts), its request (the
frame's timestamp while tracking, set by ``set_request``; the call's
ordinal under ``terminate``), its host start and end
(``time.perf_counter_ns``) and, once CUDA is initialised, a pair of CUDA
events on the current stream, with no synchronise.  Each span is also the
``torch.profiler`` range ``droid.<name>``, so in a profiler trace the
kernels launched inside it are tied to it by their launch correlation.

Spans stay in memory until ``reset()``; ``spans()`` exports them.  A span's
event pair is resolved once its end event has completed (checked without a
synchronise as later spans close) or when the spans are exported or
reported, which waits for them.

Counters are always on (integer increments, ``count``) and are read by
``counters()``: ``host_syncs.<site>`` (every blocking device-to-host read of
the tracking and terminate paths), ``corr_rounds.windowed`` and
``corr_rounds.fallback``, ``edges`` and ``edge_slots`` (the real edges and the
padded edge slots of every update-operator call), ``keyframes`` and
``ba_iterations``.
"""
import collections
import contextlib
import os
import time

import torch

# every span name, declared once; the parent each span has when the engine
# opens it is in brackets
SPANS = (
    "track",                  # root: Droid.track
    "terminate",              # root: one terminate or terminate_eva call
    "motion_filter.track",    # [track]
    "frontend",               # [track]
    "backend",                # [terminate]
    "filler",                 # [terminate]: TrajectoryFiller.__call__
    "upload",                 # a frame's host conversion and copy to the device
    "encode",                 # the feature or context encoder (fnet, cnet)
    "select",                 # add_proximity_factors: distances, selection, add_factors
    "update_fused.setup",     # update_fused's host tables
    "update_fused.device",    # fused_rounds
    "refresh",                # one step of update_lowmem's chunk loop
    "corr",                   # a correlation build or lookup, any route
    "update_op",              # a forward of the update operator
    "ba",                     # ba_iterations
    "video.ba",               # Video.ba
)

_NOOP = contextlib.nullcontext()


class Span:
    __slots__ = ("name", "parent", "request", "t0_ns", "t1_ns", "events", "device_ms")

    def __init__(self, name, parent, request, events):
        self.name, self.parent, self.request, self.events = name, parent, request, events
        self.t0_ns = time.perf_counter_ns()
        self.t1_ns = self.device_ms = None


class Tracer:
    def __init__(self, on=False):
        self.on = on
        self.request = None
        self.calls = 0
        self.records = []      # every Span since reset(), in order of start
        self.stack = []        # indices of the open spans
        self.pending = collections.deque()   # closed spans whose events are unresolved
        self.counts = collections.Counter()

    @contextlib.contextmanager
    def span(self, name):
        events = None
        if torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        rec = Span(name, self.stack[-1] if self.stack else None, self.request, events)
        self.stack.append(len(self.records))
        self.records.append(rec)
        with torch.profiler.record_function("droid." + name):
            if events:
                events[0].record()
            try:
                yield
            finally:
                rec.t1_ns = time.perf_counter_ns()
                self.stack.pop()
                if events:
                    events[1].record()
                    self.pending.append(rec)
                    self.resolve(wait=False)

    def resolve(self, wait):
        """Resolve the closed spans' event pairs, oldest first: those whose
        end has completed, or (``wait``) all of them."""
        while self.pending:
            rec = self.pending[0]
            start, end = rec.events
            if not wait and not end.query():
                break
            end.synchronize()
            rec.device_ms = start.elapsed_time(end)
            rec.events = None
            self.pending.popleft()


TRACER = Tracer(on=bool(os.environ.get("DROID_TIMING")))


def section(name):
    """A span ``name`` (one of SPANS) while the tracer is on, else a shared no-op."""
    return TRACER.span(name) if TRACER.on else _NOOP


def enable():
    TRACER.on = True


def disable():
    TRACER.on = False


def reset():
    """Forget every span and counter; outside any span."""
    if TRACER.stack:
        open_span = TRACER.records[TRACER.stack[-1]].name
        raise RuntimeError(f"timing.reset() inside the span {open_span!r}")
    TRACER.records, TRACER.calls = [], 0
    TRACER.pending.clear()
    TRACER.counts.clear()


def set_request(request):
    """The request the spans opened from now on serve."""
    TRACER.request = request


def next_call():
    """Make the next call's ordinal (0, 1, ... since reset()) the request."""
    TRACER.request = TRACER.calls
    TRACER.calls += 1


def spans():
    """Every span since reset(), in order of start: dicts of ``name``,
    ``parent`` (the index of its parent in this list, or None), ``request``,
    ``t0_ns`` and ``t1_ns`` (host clock; ``t1_ns`` None while open),
    ``host_ms`` and ``device_ms`` (the stream's time between its two events;
    None without CUDA or while open).  Waits for the device."""
    TRACER.resolve(wait=True)
    out = []
    for r in TRACER.records:
        out.append({"name": r.name, "parent": r.parent, "request": r.request,
                    "t0_ns": r.t0_ns, "t1_ns": r.t1_ns,
                    "host_ms": None if r.t1_ns is None else (r.t1_ns - r.t0_ns) * 1e-6,
                    "device_ms": r.device_ms})
    return out


def count(name, n=1):
    TRACER.counts[name] += n


def count_sync(site):
    """A blocking device-to-host read at ``site``."""
    TRACER.counts["host_syncs." + site] += 1


def counters():
    """Every counter since reset(), and each group's total under its name
    (``host_syncs`` the sum of every ``host_syncs.<site>``)."""
    out = dict(TRACER.counts)
    for k, v in TRACER.counts.items():
        if "." in k:
            group = k.split(".")[0]
            out[group] = out.get(group, 0) + v
    return out


def clear_counters(prefix):
    for k in [k for k in TRACER.counts if k.startswith(prefix)]:
        del TRACER.counts[k]


def totals():
    """Per span name: (calls, host ms, device ms or None), over the closed
    spans since reset().  Waits for the device."""
    out = {}
    for s in spans():
        if s["host_ms"] is None:
            continue
        calls, host, dev = out.get(s["name"], (0, 0.0, None))
        if s["device_ms"] is not None:
            dev = (dev or 0.0) + s["device_ms"]
        out[s["name"]] = (calls + 1, host + s["host_ms"], dev)
    return out


def summary():
    lines = []
    tot = totals()
    for name in sorted(tot, key=lambda n: tot[n][1], reverse=True):
        c, host, dev = tot[name]
        dev = "       -" if dev is None else f"{dev / 1e3:8.3f}"
        lines.append(f"{name:32s} total {host / 1e3:8.3f}s  calls {c:6d}  "
                     f"avg {host / c:8.2f}ms  device {dev}s")
    lines += [f"{k:32s} count {v}" for k, v in sorted(counters().items())]
    return "\n".join(lines)


def maybe_report():
    """Print the summary when DROID_TIMING is set."""
    if os.environ.get("DROID_TIMING"):
        print("=== droid timings ===")
        print(summary(), flush=True)


class Timer:
    """Wall-clock seconds since construction."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def elapsed(self):
        return time.perf_counter() - self.t0
