"""Shared set-up of the benchmark's tests: the repository root on the path
and the tiny CPU version of a cell.  Every test here runs on the CPU."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_cell(name):
    """The cell with its configuration cut to 64x96 frames for the CPU:
    a short warm-up, few settle frames and checked steps."""
    from port_bench.harness.cells import find_cell

    cell = find_cell(name)
    dc = cell.config["droid_config"]
    dc.update(image_size=[64, 96], buffer=96, warmup=min(dc["warmup"], 10))
    cell.traffic.update(settle_frames=2, checked_steps=2, trace_seconds=1)
    if "frames" in cell.traffic:
        cell.traffic["frames"] = 14
    return cell


def run_tiny(name, seed=2 ** 31 + 11, seconds=2.0, trace=False, dtype=None):
    import torch

    from port_bench.harness import run_cell

    torch.set_num_threads(4)
    return run_cell(tiny_cell(name), seed, seconds, trace, "cpu", dtype, log=lambda m: None)
