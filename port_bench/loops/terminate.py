"""Loop ``terminate``: whole ``Droid.terminate_eva`` calls over a tracked
sequence, each on the video restored from the snapshot that set-up took,
for ``--seconds``.

Set-up tracks the sequence's ``frames``, the first ``warmup`` +
``settle_frames`` of them as every loop does
(``harness/runner.py::track_setup``, checked by
``harness/check.py::check_tracked``), takes the snapshot and makes one
warm call.  Every call of the window is checked: its poses, disparities
and trajectory are copied to the host off the window's clock.

Parameters (the traffic file): ``frames``, ``settle_frames``,
``trace_seconds`` and the frame generator's (``harness/inputs.py``).
"""
import time

import torch

from port_bench.harness.runner import host, sync, track_setup
from port_bench.harness.stats import rel_gap
from port_bench.reference import RefDroid

RESTORED = ("poses", "disps", "disps_sens", "intrinsics", "damping", "fmaps", "nets", "inps")


def frames_needed(cfg, mix):
    return int(mix["frames"])


def snapshot(droid, slots):
    v = droid.video
    snap = {k: getattr(v, k)[:slots].clone() for k in RESTORED}
    snap["tstamp"] = v.tstamp[:slots].copy()
    snap["counter"] = v.counter
    return snap


def restore(droid, snap):
    """Put the snapshot back into the same Droid: a fresh engine state for
    terminate_eva, without reallocating the buffers."""
    v = droid.video
    for k in RESTORED:
        x = snap[k]
        getattr(v, k)[:len(x)].copy_(x)
    v.tstamp[:len(snap["tstamp"])] = snap["tstamp"]
    v.counter = snap["counter"]
    droid.frontend = None          # terminate() deletes the frontend
    droid.backend.runs.clear()


def run(runner, seed, seconds, cfg):
    """Set-up (tracking, snapshot, one warm call) and window."""
    d, dev = runner.droid, runner.device
    n_frames = frames_needed(cfg, runner.mix)
    t, states = track_setup(runner, cfg)
    for t in range(t, n_frames):
        runner.track(t)
    sync(dev)
    slots = min(d.video.poses.shape[0], d.video.counter + 16)
    snap = snapshot(d, slots)
    stream = [(float(t), runner.frames.image(t), runner.intr) for t in range(n_frames)]
    N = snap["counter"]

    def call():
        restore(d, snap)
        traj = d.terminate_eva(iter(stream))
        sync(dev)
        return traj

    def output(traj):
        return {"traj": traj, "poses": host(d.video.poses[:N]), "disps": host(d.video.disps[:N])}

    backend, filler = d.backend, d.traj_filler
    d.backend = lambda steps: runner.spans("backend", backend, steps)
    d.traj_filler = lambda s: runner.spans("filler", filler, s)
    d.backend.runs = backend.runs
    call()

    setup_end = time.perf_counter()
    outputs = []
    runner.open_window()
    while True:
        traj = call()
        outputs.append(runner.aside(output, traj))
        runner.tick(len(outputs))
        if runner.elapsed() >= seconds:
            break
    window_s, peak = runner.close_window(len(outputs))
    spans = dict(runner.spans.seconds)
    if "backend" in spans:      # two backend runs make one call's backend time
        b = spans["backend"]
        spans["backend"] = [b[i] + b[i + 1] for i in range(0, len(b) - 1, 2)]
    return {"setup_end": setup_end, "window_s": window_s, "peak_bytes": peak,
            "attempted": len(outputs), "record": {"calls": len(outputs)}, "states": states,
            "snapshot": {k: (host(v) if torch.is_tensor(v) else v) for k, v in snap.items()},
            "outputs": outputs, "n_frames": n_frames, "spans": spans}


def check(nets, cfg, frames, intr, rec, gaps, device):
    """``feat`` every keyframe's features in the snapshot that the calls
    start from, against the reference's from the raw frames; the reference
    runs terminate_eva from the snapshot's poses and disparities: ``pose``,
    ``disp`` the keyframes after the two backend runs and ``traj`` the
    filler's trajectory, of every call."""
    snap, N = rec["snapshot"], rec["snapshot"]["counter"]
    ref = RefDroid(cfg, nets, device)
    ref.load_frames([float(t) for t in range(N)], [frames.image(t) for t in range(N)],
                    None if frames.depth is None else [frames.depth_map(t) for t in range(N)],
                    [intr] * N)
    v = ref.video
    c = v.fmaps.shape[1]
    feat = max(rel_gap(snap["fmaps"][:N, :c].float(), v.fmaps[:N].cpu()),
               rel_gap(snap["nets"][:N].float(), v.nets[:N].cpu()),
               rel_gap(snap["inps"][:N].float(), v.inps[:N].cpu()))
    ref.load_state({"counter": N, "poses": snap["poses"][:N + 1], "disps": snap["disps"][:N + 1],
                    "damping": snap["damping"][:N + 1]})
    traj = ref.terminate_eva(iter([(float(t), frames.image(t), intr)
                                   for t in range(rec["n_frames"])]))
    poses, disps = v.poses[:N].cpu(), v.disps[:N].cpu()
    for out in rec["outputs"]:
        gaps.judge({"feat": feat, "pose": rel_gap(out["poses"], poses),
                    "disp": rel_gap(out["disps"], disps),
                    "traj": rel_gap(torch.as_tensor(out["traj"]), torch.as_tensor(traj))})
