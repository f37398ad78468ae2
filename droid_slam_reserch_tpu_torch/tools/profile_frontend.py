"""Per-section profile of one frontend round (the counterpart of the JAX
package's tools/profile_frontend.py).

Times each stage of the frontend's hot path in isolation at bench.py's
shape (E = 48 edges, a 24-frame window, 40x64 at 1/8 resolution, C = 128),
in the compute dtype (fp32 or bf16, ``dtype``), every correlation variant
beside it, and ``fused_rounds`` over six rounds, and returns the breakdown
as a dict:

    python -m droid_slam_reserch_tpu_torch.tools.profile_frontend          # on the card
    python -m droid_slam_reserch_tpu_torch.tools.profile_frontend --dtype bfloat16
    python -m droid_slam_reserch_tpu_torch.tools.profile_frontend --device cpu --small

prints it as one JSON line (``--small`` is bench.py's small shape, 8x16,
16 edges, an 8-frame window).  On the card each section is timed with CUDA
events around ``iters`` calls that end in a synchronize: the time of a call
as its caller sees it, host overhead included.  ``device="cpu"`` runs the
plain versions, for the tests; its times are CPU times.

The "plain" sections call the plain PyTorch spec (ops/corr.py,
ops/cuda_ba.system_blocks) directly, as the JAX tool times its XLA paths:
they are not a wrapper's CPU path, so on the card they leave the plain
call counts of ``ops.counts()`` at 0.

In bf16 the features, the update operator and the correlation are bf16
(the BA stays fp32), as in the JAX tool on the TPU: every kernel but K1
runs its bf16 instantiation, K6 over the bf16 P-major pyramid
(``build_pyramid_pmajor(dtype=bf16)``), K7 over K2's bf16 levels and K5
over K7's windows, and the lookups' errors are taken against the plain
lookup of K2's own levels (K2 and the plain build may round a sum apart).

Keys, and the JAX tool's key for the same section:

| key                          | JAX tool key                     | what runs                     |
|------------------------------|----------------------------------|-------------------------------|
| reproject_ms                 | reproject_ms                     | projective_transform          |
| build_plain_ms               | volume_pyramid_build_xla_ms      | corr_volume_flat + pyramid    |
| build_k2_ms                  | volume_pyramid_build_pallas_ms   | K2 corr_build                 |
| build_k8_ms                  | (none)                           | K8 corr_build_windows_levels  |
| lookup_plain_ms              | lookup_flat_ms                   | corr_lookup_pyramid_flat      |
| lookup_k3_ms                 | lookup_pallas_ms                 | K3 corr_lookup                |
| lookup_k6_ms                 | (none)                           | K6 over build_pyramid_pmajor  |
| extract_k7_ms                | window_extract_ms                | K7 over K2's levels           |
| build_k4_ms                  | (none)                           | K4 corr_build_windows         |
| lookup_k5_ms                 | lookup_windows_ms                | K5 over K7's windows          |
| k3_max_err                   | pallas_max_err                   | K3 against lookup_plain       |
| k6_max_err                   | (none)                           | K6 against lookup_plain       |
| k5_max_err                   | windows_max_err                  | K5(K7) against lookup_plain   |
| lookup_ref_max               | (none)                           | largest |lookup_plain|        |
| update_module_ms             | update_module_ms                 | UpdateModule + GraphAgg       |
| ba_2iter_plain_ms            | ba_2iter_xla_ms                  | 2 BA iterations, plain blocks |
| ba_2iter_k1_ms               | ba_2iter_pallas_ms               | 2 BA iterations, K1           |
| fused_6rounds_ms             | fused_6rounds_ms                 | fused_rounds (K4, then K5)    |
| fused_per_round_ms           | fused_per_round_ms               | the above / 6                 |
| sum_parts_per_round_ms       | sum_parts_per_round_ms           | reproject + K5 + update + K1  |
| build_amortized_per_round_ms | volume_amortized_per_round_ms    | (K2 + K7) / 6                 |
"""
import argparse
import json
import time

import numpy as np
import torch

from ..ba.solver import ba_iterations, schur_pairs
from ..engine.droid import resolve_device
from ..engine.factor_graph import fused_rounds
from ..engine.net_ops import compute_dtype, update_apply
from ..geom import projective_transform
from ..lie import se3_exp
from ..models import UpdateModule, init_params
from ..ops.corr import (
    build_pyramid_flat,
    build_pyramid_pmajor,
    corr_lookup_pyramid_flat,
    corr_volume_flat,
)
from ..ops.cuda_ba import ba_system_blocks, system_blocks
from ..ops.cuda_corr import (
    corr_build,
    corr_build_windows,
    corr_build_windows_levels,
    corr_extract_windows,
    corr_lookup,
    corr_lookup_pmajor,
    corr_lookup_windows,
)

ROUNDS = 6      # iters1 + iters2 per keyframe (bench.py)
FULL = dict(h8=40, w8=64, N=48, MW=24)
SMALL = dict(h8=8, w8=16, N=16, MW=8)


def edge_graph(N, MW):
    """bench.py's edges: a chain over the window plus random short edges."""
    rng = np.random.RandomState(0)
    ii = np.concatenate([np.arange(MW - 1), rng.randint(0, MW - 1, N - (MW - 1))])
    jj = np.clip(ii + rng.randint(1, 4, N), 0, MW - 1)
    jj = np.where(jj == ii, np.clip(ii + 1, 0, MW - 1), jj)
    return ii.astype(np.int64), jj.astype(np.int64)


def _timeit(fn, iters, device):
    """Mean ms of a call of fn, after one warm-up call: CUDA events on the
    card, the host clock on the CPU, around work that ends in a sync."""
    fn()
    if device.type == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


@torch.no_grad()
def profile(h8=40, w8=64, N=48, MW=24, device="cuda", iters=10, dtype="float32"):
    """The per-section breakdown at (h8, w8) with N edges over MW frames in
    the compute dtype ``dtype``; see the module docstring for the keys."""
    dev = resolve_device(device)
    dt = compute_dtype(dtype)
    fp32 = dt == torch.float32

    def timeit(fn, n):
        return _timeit(fn, n, dev)

    gen = torch.Generator(device=dev).manual_seed(0)
    P = h8 * w8

    # bench.py's synthetic state
    poses = se3_exp(0.03 * torch.randn(MW, 6, generator=gen, device=dev))
    disps = torch.ones(MW, h8, w8, device=dev)
    intr = torch.tensor([w8 * 4.0, w8 * 4.0, w8 / 2.0, h8 / 2.0], device=dev)
    intr_win = intr.expand(MW, 4)
    fmaps = (0.1 * torch.randn(MW, h8, w8, 128, generator=gen, device=dev)).to(dt)
    ii, jj = edge_graph(N, MW)
    be, bm = schur_pairs(ii, MW)
    ii, jj = torch.as_tensor(ii, device=dev), torch.as_tensor(jj, device=dev)
    be, bm = torch.as_tensor(be, device=dev).long(), torch.as_tensor(bm, device=dev)
    f1, f2 = fmaps[ii].contiguous(), fmaps[jj].contiguous()
    # the update operator with the seeded random weights of init_params
    update = UpdateModule()
    update.load_state_dict({k[len("update."):]: v for k, v in init_params(0).items()
                            if k.startswith("update.")})
    update.to(dev, dt).eval().requires_grad_(False)
    res = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "h8": h8, "w8": w8, "edges": N, "window": MW, "dtype": dtype}

    def reproject():
        return projective_transform(poses[None], disps[None], intr_win[None], ii, jj)[0][0]

    res["reproject_ms"] = timeit(reproject, iters)
    coords1 = reproject()
    cflat = coords1.reshape(N, P, 2).contiguous()

    # volume + pyramid builds (once per keyframe)
    def build_plain():
        return build_pyramid_flat(corr_volume_flat(f1, f2).to(dt))

    res["build_plain_ms"] = timeit(build_plain, iters)
    res["build_k2_ms"] = timeit(lambda: corr_build(f1, f2), iters)
    levels = corr_build(f1, f2)
    res["build_k8_ms"] = timeit(lambda: corr_build_windows_levels(f1, f2, cflat), iters)
    res["build_k4_ms"] = timeit(lambda: corr_build_windows(f1, f2, cflat), iters)

    # lookups (per round), each held against the plain flat lookup (in bf16,
    # of K2's own levels: K2 and the plain build may round a sum apart)
    ref = corr_lookup_pyramid_flat(build_plain() if fp32 else levels, cflat)

    def max_err(out):
        return float((out.float() - ref.float()).abs().max())

    res["lookup_ref_max"] = float(ref.float().abs().max())

    res["lookup_plain_ms"] = timeit(lambda: corr_lookup_pyramid_flat(levels, cflat), iters)
    res["lookup_k3_ms"] = timeit(lambda: corr_lookup(levels, cflat), iters)
    res["k3_max_err"] = max_err(corr_lookup(levels, cflat))
    padded, _ = build_pyramid_pmajor(f1, f2, dtype=dt)
    res["lookup_k6_ms"] = timeit(lambda: corr_lookup_pmajor(padded, cflat), iters)
    res["k6_max_err"] = max_err(corr_lookup_pmajor(padded, cflat))
    del padded
    res["extract_k7_ms"] = timeit(lambda: corr_extract_windows(levels, cflat), iters)
    wins, bases = corr_extract_windows(levels, cflat)
    res["lookup_k5_ms"] = timeit(lambda: corr_lookup_windows(wins, bases, cflat, (h8, w8)), iters)
    res["k5_max_err"] = max_err(corr_lookup_windows(wins, bases, cflat, (h8, w8)))
    del levels, wins, bases

    # the update operator alone
    nets = torch.zeros(N, h8, w8, 128, dtype=dt, device=dev)
    inps = torch.zeros(N, h8, w8, 128, dtype=dt, device=dev)
    corr = ref.reshape(N, h8, w8, -1)
    motn = torch.zeros(N, h8, w8, 4, dtype=dt, device=dev)
    res["update_module_ms"] = timeit(
        lambda: update(nets[None], inps[None], corr[None], motn[None], ii, MW), iters)

    # dense BA, 2 Gauss-Newton iterations
    free = torch.arange(MW, device=dev) >= 1
    weight = torch.full((N, h8, w8, 2), 0.5, device=dev)
    eta = torch.full((MW, h8, w8), 1e-4, device=dev)
    dsens = torch.zeros(MW, h8, w8, device=dev)

    def ba2(blocks):
        return ba_iterations(poses, disps, intr, dsens, coords1, weight, eta, ii, jj, free,
                             be, bm, iterations=2, lm=1e-4, ep=0.1, min_depth=0.25,
                             blocks=blocks)

    res["ba_2iter_plain_ms"] = timeit(lambda: ba2(system_blocks), iters)
    res["ba_2iter_k1_ms"] = timeit(lambda: ba2(ba_system_blocks), iters)

    # the whole per-keyframe round loop
    has_edge = torch.zeros(MW, dtype=torch.bool, device=dev)
    has_edge[ii] = True
    damping = torch.full((MW, h8, w8), 1e-6, device=dev)
    empty = torch.zeros(0, h8, w8, 2, device=dev)

    def fused():
        return fused_rounds(
            update_apply, update, poses, disps, dsens, damping, intr, f1, f2, nets, inps,
            torch.zeros(N, h8, w8, 2, device=dev), ii, jj, ii,
            torch.ones(N, dtype=torch.bool, device=dev), has_edge, ii, jj, empty, empty,
            free, be, bm, rounds=ROUNDS, ba_iters=2, lm=1e-4, ep=0.1, damping_eps=1e-7,
            min_depth=0.25, beta=0.3)

    res["fused_6rounds_ms"] = timeit(fused, max(1, iters // 5))
    res["fused_per_round_ms"] = res["fused_6rounds_ms"] / ROUNDS
    res["sum_parts_per_round_ms"] = (res["reproject_ms"] + res["lookup_k5_ms"]
                                     + res["update_module_ms"] + res["ba_2iter_k1_ms"])
    res["build_amortized_per_round_ms"] = (res["build_k2_ms"] + res["extract_k7_ms"]) / ROUNDS
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="bench.py's small shape")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="the compute dtype (DroidConfig.compute_dtype)")
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False          # fp32 in full, as the tests
    torch.backends.cuda.matmul.allow_tf32 = False
    shape = SMALL if args.small else FULL
    print(json.dumps(profile(**shape, device=args.device, dtype=args.dtype)), flush=True)


if __name__ == "__main__":
    main()
