"""Model FLOPs (every nn.Conv2d forward from its shapes, plus the
correlation products of K2 and K4) in the profiled stretch over its
seconds times the fp32-accurate tensor-core peak, 165 TFLOP/s."""
from port_bench.harness.stats import mfu_pct

UNIT, BETTER, LAYER = "%", "higher", "whole step (model + kernels)"


def read(rec):
    t = rec.trace
    if t is None:
        return None
    products = sum(w[1] for k, w in t["work"].items() if k in ("K2", "K4"))
    return mfu_pct(t["conv_flops"] + products, t["window_s"])
