"""K3 and K5 (csrc/corr_lookup.cu, csrc/corr_windows_lookup.cu) built from
several source directories and compared in one run, fp32 and bf16.

    python -m droid_slam_reserch_tpu_torch.tools.lookup_sources \\
        --src parent=build/parent/droid_slam_reserch_tpu_torch/csrc \\
        --src change=droid_slam_reserch_tpu_torch/csrc

Each directory's two sources are built by nvcc into a library each under
``build/lookup_sources/`` (windows_build_phases' build helper, one process a
library, all started together), and so is each variant whose lines a source
holds; the committed sources carry no switch:

    tile32  K3 bf16 with 32-pixel tiles (128 threads a block) instead of 16
    ldg     K5 bf16 reading its span's rows as 16-byte chunks into registers
            (chunk sx / 8, and sx / 8 + 1 where sx % 8 != 0: up to 16 loads
            a thread) instead of one bulk copy of the 8 rows into shared
            memory

Every library's kernel is held against the plain version (cells that differ;
the bf16 kernels and fp32 K3 round as the plain version does, so 0) and
compared bit for bit with the first library's, at E = 48 and 1 over 40x64, at
the ragged 30x45, 24x34, 24x66, 8x12 and 27x45 (odd P, so the runs of odd
edges start at odd pixels), and at 40x64 with levels and windows that start
2 bytes past a 16-byte boundary (the 2-byte loads); then each is timed by
chip_smoke's cuda_ms at E = 48 and 1 over 40x64 in the order lib1, lib2, ...,
lib2, lib1, beside F.grid_sample (one call a level; bf16 with a bf16 grid).
Runs on the card only; prints the kernels' ptxas lines, one line a
measurement and a JSON line of all.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

from .windows_build_phases import build_sources

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_REPO, "droid_slam_reserch_tpu_torch", "csrc")
OUT = os.path.join(_REPO, "build", "lookup_sources")

# kernel: (source file, C launch functions fp32 and bf16, ptxas names)
KERNELS = {
    "k3": ("corr_lookup.cu", ("corr_lookup_launch", "corr_lookup_bf16_launch"),
           ("corr_lookup_kernel", "corr_lookup_bf16_kernel")),
    "k5": ("corr_windows_lookup.cu",
           ("corr_windows_lookup_launch", "corr_windows_lookup_bf16_launch"),
           ("windows_lookup_kernel", "windows_lookup_bf16_kernel")),
}
_K5_COPY = """      bulk_copy(smem_addr(spans[tid]), w, 16 * m.ww_max, smem_addr(&bar));
      wait_phase0(smem_addr(&bar));
"""
_K5_LOADS = """      const uint4* r = reinterpret_cast<const uint4*>(w) + (sx >> 3);
      uint4 lo[8], hi[8];
#pragma unroll
      for (int i = 0; i < 8; i++) {
        lo[i] = __ldg(r + i * (m.ww_max >> 3));
        hi[i] = sx & 7 ? __ldg(r + i * (m.ww_max >> 3) + 1) : make_uint4(0, 0, 0, 0);
      }
"""
_K5_SPAN8 = """        rows[i] = lookup_bf16::span8(spans[tid][i * rc + c0],
                                     s ? spans[tid][i * rc + c0 + 1] : make_uint4(0, 0, 0, 0), s);
"""
VARIANTS = {       # kernel: {name: [(text of the bf16 kernel's source, its replacement), ...]}
    "k3": {"tile32": [("constexpr int kTileB = 16;", "constexpr int kTileB = 32;")]},
    "k5": {"ldg": [("uint4 spans[kBulk ? kThreadsB : 1][kSpanChunks];",
                    "uint4 spans[1][kSpanChunks];"),
                   (_K5_COPY, _K5_LOADS),
                   (_K5_SPAN8, "        rows[i] = lookup_bf16::span8(lo[i], hi[i], s);\n")]},
}
# (E, H, W, byte offset of the levels and windows): the timed shapes first
TIMED = [(48, 40, 64, 0), (1, 40, 64, 0)]
HELD = [(2, 30, 45, 0), (2, 24, 34, 0), (2, 24, 66, 0), (2, 8, 12, 0), (2, 27, 45, 0),
        (2, 40, 64, 2)]
C = 128


def variant_texts(name, csrc):
    """{(kernel, key): (text, header directory)}: each source of `csrc` under
    `name`, and under `name-variant` each variant whose lines it holds
    exactly once each."""
    out = {}
    for kern, (filename, _, _) in KERNELS.items():
        with open(os.path.join(csrc, filename)) as f:
            text = f.read()
        out[kern, name] = (text, csrc)
        for v, edits in VARIANTS[kern].items():
            if all(text.count(old) == 1 for old, _ in edits):
                edited = text
                for old, new in edits:
                    edited = edited.replace(old, new)
                out[kern, f"{name}-{v}"] = (edited, csrc)
    return out


def _load(path, kern):
    from droid_slam_reserch_tpu_torch.ops import build

    lib = ctypes.CDLL(path)
    for name in KERNELS[kern][1]:
        getattr(lib, name).argtypes = build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def shifted(torch, x, offset):
    """x copied to a tensor that starts `offset` bytes past a 16-byte boundary."""
    if not offset:
        return x
    n, k = x.numel(), offset // x.element_size()
    buf = torch.empty(n + 16, dtype=x.dtype, device=x.device)
    out = buf[k:k + n].view(x.shape)
    out.copy_(x)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", default=[],
                    help="NAME=DIR of a csrc directory (default: this checkout's)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("lookup_sources: no CUDA card")
    sys.path.insert(0, _REPO)
    from chip_smoke import (cuda_ms, grid_sample_inputs, grid_sample_lookup, lookup_coords,
                            ptxas_report)
    from droid_slam_reserch_tpu_torch.geom import coords_grid
    from droid_slam_reserch_tpu_torch.ops import build, cuda_corr
    from droid_slam_reserch_tpu_torch.ops.corr import level_sizes, pack_offsets, win_shape

    texts = {}
    for s in args.src or [f"this={CSRC}"]:
        texts.update(variant_texts(*s.split("=", 1)))
    keys = {kern: [k for kk, k in texts if kk == kern] for kern in KERNELS}
    libs = {}
    for kern, (filename, _, names) in KERNELS.items():
        paths = build_sources({k: texts[kern, k] for k in keys[kern]},
                              os.path.join(OUT, kern), filename)
        libs[kern] = {k: _load(p, kern) for k, p in paths.items()}
    report = {"ptxas": {}, "plain_cells_differ": {}, "cells_differ": {}, "ms": {}}
    bad = []
    for kern, (_, _, names) in KERNELS.items():
        for k in keys[kern]:
            with open(os.path.join(OUT, kern, k, "ptxas.txt")) as f:
                lines = ptxas_report(f.read(), names)
            report["ptxas"][f"{kern} {k}"] = lines
            for line in lines:
                print(f"[lookups] {kern} {k} ptxas: {line}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(kern, lib, dt, inputs, coords, out, hw):
        E, P = coords.shape[:2]
        fn = getattr(lib, KERNELS[kern][1][dt == bf16])
        a = [v.data_ptr() for v in inputs] + [coords.data_ptr(), E, P, *hw, out.data_ptr(),
                                              stream]
        return lambda: build.check(fn(*a), f"{kern} {dt}")

    for E, H, W, offset in TIMED + HELD:
        at = f"E={E} {H}x{W}" + (f" +{offset} bytes" if offset else "")
        P = H * W
        grid = coords_grid(H, W, device=dev).reshape(1, P, 2)
        for dt in (f32, bf16):
            if offset % torch.empty(0, dtype=dt).element_size():
                continue
            scale = 0.3 if dt == bf16 else 1.0
            f1 = (scale * torch.randn(E, H, W, C, generator=gen, device=dev)).to(dt)
            f2 = (scale * torch.randn(E, H, W, C, generator=gen, device=dev)).to(dt)
            levels = cuda_corr.corr_build_plain(f1, f2)
            coords = lookup_coords(torch, grid, E, gen)["random"]
            c0 = lookup_coords(torch, grid, E, gen)["random"]
            wins, bases = cuda_corr.corr_build_windows_plain(f1, f2, c0)
            c1 = (c0 + 4.0 * torch.rand(E, P, 2, generator=gen, device=dev) - 2.0).contiguous()
            del f1, f2
            cases = {"k3": ([shifted(torch, v, offset) for v in levels], coords,
                            cuda_corr.corr_lookup_plain(levels, coords)),
                     "k5": ([shifted(torch, wins, offset), bases], c1,
                            cuda_corr.corr_lookup_windows_plain(wins, bases, c1, (H, W)))}
            for kern, (inputs, cc, plain) in cases.items():
                ref = None
                for k in keys[kern]:
                    out = torch.empty_like(plain)
                    launcher(kern, libs[kern][k], dt, inputs, cc, out, (H, W))()
                    torch.cuda.synchronize()
                    what = f"{kern} {dt} {at}"
                    differ = int((out != plain).sum())
                    err = float((out.float() - plain.float()).abs().max())
                    report["plain_cells_differ"][f"{k} {what}"] = differ
                    if differ and not (kern == "k5" and dt == f32):   # fp32 K5 takes FMAs
                        bad.append(f"{k} {what} against the plain version")
                    line = (f"[lookups] {what}: {k} against the plain version {differ} cells "
                            f"differ (max {err:.3e})")
                    if ref is None:
                        ref = out
                    else:
                        same = int((out != ref).sum())
                        report["cells_differ"][f"{keys[kern][0]}/{k} {what}"] = same
                        if same:
                            bad.append(f"{k} {what} against {keys[kern][0]}")
                        line += f", against {keys[kern][0]} {same} cells differ"
                    print(line, flush=True)
                del ref, out
            if (E, H, W, offset) in TIMED:
                reps = 40 if E > 1 else 200
                sizes = level_sizes(H, W)
                views = [wins[:, :, o:o + win_shape(*hw)[0], :win_shape(*hw)[1]]
                         for o, hw in zip(pack_offsets(sizes)[0], sizes)]
                gs = {"k3": grid_sample_inputs(torch, levels, coords),
                      "k5": grid_sample_inputs(torch, views, c1, bases)}
                for kern, (inputs, cc, plain) in cases.items():
                    out = torch.empty_like(plain)
                    g = [(v, x.to(dt)) for v, x in gs[kern]]
                    for k in keys[kern] + keys[kern][::-1]:
                        ms = cuda_ms(torch, launcher(kern, libs[kern][k], dt, inputs, cc, out,
                                                     (H, W)), reps)
                        report["ms"].setdefault(f"{kern} {k} {dt} {at}", []).append(ms)
                        print(f"[lookups] {kern} {k} {dt} {at}: {ms:.4f} ms", flush=True)
                    ms = cuda_ms(torch, lambda: grid_sample_lookup(torch, g), reps)
                    report["ms"][f"{kern} F.grid_sample {dt} {at}"] = [ms]
                    print(f"[lookups] {kern} F.grid_sample x4 {dt} {at}: {ms:.4f} ms", flush=True)
                del gs, g, views, out
            del levels, wins, bases, cases, plain
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    report["card"] = smi
    print(json.dumps(report), flush=True)
    if bad:
        sys.exit(f"lookup_sources: cells differ: {bad}")


if __name__ == "__main__":
    main()
