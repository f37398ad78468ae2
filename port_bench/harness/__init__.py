"""The benchmark of the PyTorch/CUDA port of DROID-SLAM: one cell, one run.

``run_cell`` builds the cell's configuration, makes its frames and weights
from the seed, runs its set-up and measured window by its traffic mix's
loop (``port_bench/loops/<loop>.py``), checks what the window produced
against the plain reference (``check`` and the loop's own comparisons)
and returns the result line; ``main`` is ``run.py``'s command line.
"""
import argparse
import gc
import json
import math
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "droid_slam_reserch_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Record:
    """What the readers of metrics/ read: the window, the spans, the trace.
    A loop sets the fields of its own work (``frames`` and ``latencies``,
    or ``calls``); the others stay empty."""

    def __init__(self, **kw):
        self.setup_s = self.window_s = None
        self.frames = self.calls = None
        self.latencies = []
        self.peak_bytes = 0
        self.spans = {}
        self.trace = None
        self.__dict__.update(kw)


def smi():
    """The card's name, power limit, clocks, power draw and temperature
    from nvidia-smi, or None where it cannot be read."""
    fields = "name,power.limit,clocks.sm,clocks.max.sm,power.draw,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return dict(zip(fields.split(","), (x.strip() for x in out.stdout.splitlines()[0].split(","))))


def _template():
    import torch

    from port_bench.reference.nets import Networks

    with torch.device("meta"):
        return Networks().state_dict()


def run_cell(cell, seed, seconds, trace, device, dtype=None, log=print, t_start=None):
    """One run of ``cell`` (cells.Cell), its set-up counted from ``t_start``
    (a ``time.perf_counter()`` reading; default now).  Returns the result
    object."""
    import torch

    from droid_slam_reserch_tpu_torch.engine import Droid
    from droid_slam_reserch_tpu_torch.utils.config import DroidConfig

    from . import check, inputs
    from .runner import Runner

    t_start = time.perf_counter() if t_start is None else t_start
    seed = int(seed) % 2 ** 63
    device = torch.device(device)
    cfg_dict = cell.droid_config
    if dtype is not None:
        cfg_dict["compute_dtype"] = dtype
    precision = cell.config["precision"]
    torch.backends.cuda.matmul.allow_tf32 = precision["tf32"]
    torch.backends.cudnn.allow_tf32 = precision["tf32"]
    cfg = DroidConfig(**{**cfg_dict, "image_size": tuple(cfg_dict["image_size"])})
    mix, loop = cell.traffic, cell.loop
    intr = cell.config["intrinsics"]
    frames = inputs.Frames(seed, loop.frames_needed(cfg, mix), cfg.image_size, mix, cfg.stereo,
                           cfg.rgbd)
    params = inputs.weights(seed, device, _template())
    droid = Droid(cfg, params=params, device=device)
    runner = Runner(droid, frames, intr, device, trace, mix)
    smi_before = smi() if device.type == "cuda" else None

    rec = loop.run(runner, seed, seconds, cfg)
    record = Record(setup_s=rec["setup_end"] - t_start, window_s=rec["window_s"],
                    peak_bytes=rec["peak_bytes"], spans=rec["spans"], **rec["record"])
    attempted = rec["attempted"]
    smi_after = smi() if device.type == "cuda" else None
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if runner.profiled is not None:
        record.trace = dict(runner.profiled.reduce(), units=runner.units_traced,
                            work=runner.probe.kernel_work(),
                            conv_flops=runner.probe.conv_flops)
        log(f"traced: {runner.units_traced} units; K1-K5 launches in the trace "
            f"{dict(record.trace['count_kernel'])}, calls the wrappers counted "
            f"{ {k: w[0] for k, w in record.trace['work'].items()} }")
    del droid, runner
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref_cfg = dict(cfg_dict, compute_dtype="float32")      # the reference is fp32
    gaps, check_s = check.run_check(loop, params, ref_cfg, frames, intr, rec,
                                    cell.limits, device)
    for line in gaps.info:
        log(line)
    log(f"reference check: {check_s:.1f} s")

    readers = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m, reader in readers:
        value = reader.read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    if smi_before:
        dev["smi_before"], dev["smi_after"] = smi_before, smi_after
    result = {"correct": gaps.correct, "attempted": attempted, "failed": gaps.failed,
              "metrics": metrics, "device": dev}
    if trace and record.trace is not None:
        t = record.trace
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in t["by_name"].most_common(10)],
            "idle_gaps": [[n, s] for n, s in t["idle"].most_common(10)]}
    result["compared"] = {k: {"value": v if math.isfinite(v) else str(v), "limit": cell.limits[k]}
                          for k, v in gaps.worst.items()}
    return result


def main(argv=None, t_start=None):
    from .cells import find_cell

    ap = argparse.ArgumentParser(prog="port_bench/run.py", description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dtype", default=None,
                    help="run the program in another compute dtype (the check's control)")
    args = ap.parse_args(argv)

    cell = find_cell(args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: this cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2

    def log(msg):
        print(f"[port_bench] {msg}", file=sys.stderr, flush=True)

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", args.dtype, log,
                      t_start)
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: the run loaded {bad}: nothing it runs may import JAX or the JAX "
              f"package", file=sys.stderr)
        return 3
    for k, c in result["compared"].items():
        log(f"compared {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result, default=float, allow_nan=False))
    return 0
