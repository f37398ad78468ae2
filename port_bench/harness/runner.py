"""What every loop (``port_bench/loops/<loop>.py``) drives the program
with: the ``Runner`` around one ``Droid``, its synchronised spans, and the
measured window's clock.

The window's clock counts the seconds since the window opened less the
harness's own work inside it: the host copies of the program's state that
the check takes (``Runner.aside``) and the profiler's teardown.  A rate or a time per call is taken
over all the program's work and all of that time.  With ``trace`` every
call into a layer is a synchronised host span and a profiler range, and
the first ``trace_seconds`` of the window run under torch.profiler.
"""
import time

import torch

from .probes import SPAN_PREFIX, Probe, Profiled


class Spans:
    """Synchronised host-clock spans by name, each also a profiler range."""

    def __init__(self, on, device):
        self.on, self.device = on, device
        self.seconds = {}

    def __call__(self, name, fn, *args, **kw):
        if not self.on:
            return fn(*args, **kw)
        sync(self.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(SPAN_PREFIX + name):
            out = fn(*args, **kw)
            sync(self.device)
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)
        return out


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def host(x):
    """A host copy (``.cpu()`` alone aliases a CPU tensor)."""
    return x.detach().to("cpu", copy=True)


def graph_state(droid, frames):
    """The frontend's edges and their hidden states after ``frames`` frames
    were handed to ``track``."""
    g = droid.frontend.graph
    return {"frames": frames, "ii": g.ii.copy(), "jj": g.jj.copy(),
            "net": host(g.net.float())}


def capture_pre(droid):
    """The program's state before a frame: what the next step reads."""
    v, f = droid.video, droid.frontend
    g = f.graph
    n = v.counter + 1
    state = {"counter": v.counter, "t0": f.t0, "t1": f.t1, "is_initialized": f.is_initialized}
    for k in ("poses", "disps", "damping"):
        state[k] = host(getattr(v, k)[:n])
    for k in ("ii", "jj", "age", "ii_inac", "jj_inac", "ii_bad", "jj_bad"):
        state[k] = getattr(g, k).copy()
    for k in ("net", "target", "weight", "target_inac", "weight_inac"):
        state[k] = host(getattr(g, k).float())
    return state


def capture_post(droid, slot):
    """What a step produced: the state it leaves and the new frame's features."""
    v, g = droid.video, droid.frontend.graph
    n = v.counter + 1
    return {"counter": v.counter, "poses": host(v.poses[:n]), "disps": host(v.disps[:n]),
            "ii": g.ii.copy(), "jj": g.jj.copy(), "net": host(g.net.float()),
            "fmaps": host(v.fmaps[slot].float()), "nets": host(v.nets[slot].float()),
            "inps": host(v.inps[slot].float())}


def track_setup(runner, cfg):
    """Set-up's tracking: frames 0 .. warmup - 1, through initialisation,
    then the mix's ``settle_frames`` more, each of them a step that the
    check follows from the program's state before it.  Returns the frames
    tracked and what the check reads: the frontend's edge states right
    after initialisation (``init_net``), each settle frame's state before
    and after its step (``settle``), and the seconds those copies took
    (``capture_s``)."""
    d = runner.droid
    t = 0
    while t < cfg.warmup:
        runner.track(t)
        t += 1
    if not d.frontend.is_initialized:
        raise RuntimeError("the frontend did not initialise during set-up")
    states = {"init_net": graph_state(d, t), "settle": [], "capture_s": 0.0}
    for _ in range(int(runner.mix["settle_frames"])):
        sync(runner.device)
        t0 = time.perf_counter()
        pre = capture_pre(d)
        states["capture_s"] += time.perf_counter() - t0
        runner.track(t)
        sync(runner.device)
        t0 = time.perf_counter()
        states["settle"].append({"frame": t, "pre": pre,
                                 "post": capture_post(d, pre["counter"])})
        states["capture_s"] += time.perf_counter() - t0
        t += 1
    return t, states


class Runner:
    def __init__(self, droid, frames, intrinsics, device, trace, mix):
        self.droid, self.frames, self.intr = droid, frames, intrinsics
        self.device, self.trace, self.mix = device, trace, mix
        self.spans = Spans(trace, device)
        self.probe = Probe() if trace else None
        self.profiled = None
        self.units_traced = 0
        self.w0 = None
        self.set_aside = 0.0

    def track(self, t):
        """``Droid.track`` of frame t; with ``trace``, its two layers each in a span."""
        img, depth = self.frames.image(t), self.frames.depth_map(t)
        d = self.droid
        if not self.trace:
            d.track(float(t), img, depth=depth, intrinsics=self.intr)
            return
        with torch.no_grad():
            self.spans("motion_filter", d.filterx.track, float(t), img, depth, self.intr)
            self.spans("frontend", d.frontend)

    # -- the window
    def open_window(self):
        """Reset the peak, start the profiler with ``trace``, start the clock."""
        sync(self.device)
        self.spans.seconds.clear()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        if self.trace:
            self.probe.install(self.droid)
            self.profiled = Profiled(self.probe, self.device).__enter__()
        self.set_aside = 0.0
        self.w0 = time.perf_counter()

    def elapsed(self):
        """The window's seconds so far, the harness's copies left out."""
        return time.perf_counter() - self.w0 - self.set_aside

    def aside(self, fn, *args):
        """The check's copy ``fn(*args)``: off the window's clock, and a
        profiler range that the trace's reduction leaves out."""
        sync(self.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(SPAN_PREFIX + "capture"):
            out = fn(*args)
        self.set_aside += time.perf_counter() - t0
        return out

    def tick(self, units):
        """After each unit of work: end the profiled stretch once it has
        lasted ``trace_seconds``."""
        if self.profiled is not None and self.profiled.running \
                and self.elapsed() >= self.mix["trace_seconds"]:
            t0 = time.perf_counter()
            self.profiled.__exit__(None, None, None)
            self.set_aside += time.perf_counter() - t0      # the profiler's own teardown
            self.units_traced = units

    def close_window(self, units):
        """The window's seconds and the peak of device memory in it."""
        window_s = self.elapsed()
        peak = torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0
        if self.profiled is not None and self.profiled.running:
            self.profiled.__exit__(None, None, None)
            self.units_traced = units
        if self.probe is not None:
            self.probe.uninstall()
        return window_s, peak
