"""The lookups K3, K5 and K6 and the window extraction K7 (csrc/corr_lookup.cu,
csrc/corr_windows_lookup.cu, csrc/corr_pmajor_lookup.cu,
csrc/corr_extract_windows.cu) built from several source directories and
compared in one run, fp32 and bf16.

    python -m droid_slam_reserch_tpu_torch.tools.lookup_sources \\
        --src parent=build/parent/droid_slam_reserch_tpu_torch/csrc \\
        --src change=droid_slam_reserch_tpu_torch/csrc [--kernels k6,k7]

Each directory's sources are built by nvcc into a library each under
``build/lookup_sources/`` (windows_build_phases' build helper, one process a
library, all started together), and so is each variant whose lines a source
holds; the committed sources carry no switch:

    tile32  K3 bf16 with 32-pixel tiles (128 threads a block) instead of 16
    ldg     K5 bf16 reading its span's rows as 16-byte chunks into registers
            (chunk sx / 8, and sx / 8 + 1 where sx % 8 != 0: up to 16 loads
            a thread) instead of one bulk copy of the 8 rows into shared
            memory
    tile16  K6 bf16 with groups of 16 pixels (one 32-byte sector a cell) and
            a buffer of 1,024 such cells, instead of 32 pixels and 768 cells
    gather  K6 bf16 with every group gathering its cells through L1, none
            copying its boxes into shared memory
    copyonly  K6 bf16 copying its boxes and storing the buffer, no blends
    nocopy  K6 bf16 blending from a buffer it never fills (the copies skipped)
    tile16  K7 bf16 with 16 pixels a block (384 threads) instead of 32
    rowthread  K7 bf16 with a thread per window row storing its 16-byte
            chunks in turn (48 bytes apart across lanes) instead of a thread
            per chunk
    stcs    K7 bf16 storing its windows with streaming (evict-first) stores

copyonly and nocopy take a phase out, so their outputs are wrong: they are
timed and not held (PHASES).
Every library's kernel is held against the plain version (cells that differ;
the bf16 kernels and fp32 K3 round as the plain version does, so 0) and
compared bit for bit with the first library's, at E = 48 and 1 over 40x64, at
the ragged 30x45, 24x34, 24x66, 8x12 and 27x45 (odd P, so the runs of odd
edges start at odd pixels), and at 40x64 with levels and windows that start
2 bytes past a 16-byte boundary (the 2-byte loads); K6 with four kinds of
coords (coords_kinds), K7's windows and bases around the random ones.  Then each
is timed by chip_smoke's cuda_ms at E = 48 and 1 over 40x64 in the order
lib1, lib2, ..., lib2, lib1 (K6 with the random coords and under the pan),
beside F.grid_sample (one call a level, bilinear at the lookups' 7x7 grids
and K6 over K2's levels, nearest at K7's window cells; bf16 with a bf16
grid).  For K6 bf16 it also counts, for each kind of coords, the 32-pixel
groups that copy their boxes into shared memory and those that gather
(pmajor_groups, the kernel's rule).  Runs on the card only; prints the
kernels' ptxas lines and one line a measurement, and writes a JSON of all
to ``chiprun_out/lookup_sources.json``.
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
REPORT = os.path.join(_REPO, "chiprun_out", "lookup_sources.json")

# kernel: (source file, C launch functions fp32 and bf16, ptxas names)
KERNELS = {
    "k3": ("corr_lookup.cu", ("corr_lookup_launch", "corr_lookup_bf16_launch"),
           ("corr_lookup_kernel", "corr_lookup_bf16_kernel")),
    "k5": ("corr_windows_lookup.cu",
           ("corr_windows_lookup_launch", "corr_windows_lookup_bf16_launch"),
           ("windows_lookup_kernel", "windows_lookup_bf16_kernel")),
    "k6": ("corr_pmajor_lookup.cu",
           ("corr_pmajor_lookup_launch", "corr_pmajor_lookup_bf16_launch"),
           ("pmajor_lookup_kernel", "pmajor_lookup_bf16_kernel")),
    "k7": ("corr_extract_windows.cu",
           ("corr_extract_windows_launch", "corr_extract_windows_bf16_launch"),
           ("extract_windows_kernel", "extract_windows_bf16_kernel")),
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
_K7_CHUNKS = """    const int per = m.WH[l] * runs, n = np * per;   // (row, chunk) items a pixel, a tile
    for (int i = tid; i < n; i += kThreadsB) {
      const int q = i / per, rk = i - q * per, r = rk / runs, k = rk - r * runs;
      const int2 b = base[l][q];
      const int y = b.x + r - kPad, x0 = b.y - kPad + 8 * k;   // the chunk's first cell
"""
_K7_ROWS = """    const int n = np * m.WH[l];
    for (int i = tid; i < n; i += kThreadsB)
    for (int k = 0; k < runs; k++) {
      const int q = i / m.WH[l], r = i - q * m.WH[l];
      const int2 b = base[l][q];
      const int y = b.x + r - kPad, x0 = b.y - kPad + 8 * k;   // the chunk's first cell
"""
VARIANTS = {       # kernel: {name: [(text of the bf16 kernel's source, its replacement), ...]}
    "k3": {"tile32": [("constexpr int kTileB = 16;", "constexpr int kTileB = 32;")]},
    "k5": {"ldg": [("uint4 spans[kBulk ? kThreadsB : 1][kSpanChunks];",
                    "uint4 spans[1][kSpanChunks];"),
                   (_K5_COPY, _K5_LOADS),
                   (_K5_SPAN8, "        rows[i] = lookup_bf16::span8(lo[i], hi[i], s);\n")]},
    "k6": {"tile16": [("constexpr int kTileB = 32;", "constexpr int kTileB = 16;"),
                      ("constexpr int kBoxCells = 768;", "constexpr int kBoxCells = 1024;")],
           "gather": [("const bool staged = np == kTileB && cells <= kBoxCells;",
                       "const bool staged = false;")],
           "copyonly": [("const bool live = q < np && a < kD;",
                         "const bool live = q < np && a < kD && P < 0;")],
           "nocopy": [("          cp_async16(smem_addr(buf + kCellChunks * at[l] + i),",
                       "          if (P < 0)\n"
                       "          cp_async16(smem_addr(buf + kCellChunks * at[l] + i),")]},
    "k7": {"tile16": [("constexpr int kTileB = 32;", "constexpr int kTileB = 16;")],
           "rowthread": [(_K7_CHUNKS, _K7_ROWS)],
           "stcs": [("        *reinterpret_cast<uint4*>(d) = v;\n",
                     "        __stcs(reinterpret_cast<uint4*>(d), v);\n")]},
}
# (E, H, W, byte offset of the levels and windows): the timed shapes first
TIMED = [(48, 40, 64, 0), (1, 40, 64, 0)]
HELD = [(2, 30, 45, 0), (2, 24, 34, 0), (2, 24, 66, 0), (2, 8, 12, 0), (2, 27, 45, 0),
        (2, 40, 64, 2)]
C = 128
PHASES = {("k6", "copyonly"), ("k6", "nocopy")}     # timed, not held
# K6 bf16's groups (csrc/corr_pmajor_lookup.cu): pixels a group, cells (of a
# group's pixels) its four boxes may hold
GROUP, BOX_CELLS = 32, 768


def coords_kinds(torch, grid, E, gen):
    """K6's coords: chip_smoke's "random" (2 px of noise, the first 64
    pixels 50 px off the image) and "pan4"; "off", every pixel 60 px past the
    image's far corner (every span clamped into the border); "split", the odd
    pixels 60 px before the image's first corner (nearly every group's boxes
    too large, so nearly every group gathers)."""
    from chip_smoke import lookup_coords

    kinds = lookup_coords(torch, grid, E, gen)
    noise = 2.0 * torch.randn(E, grid.shape[1], 2, generator=gen, device=grid.device)
    kinds["off"] = (grid + 60.0 + noise).contiguous()
    split = (grid + noise).contiguous()
    split[:, 1::2] -= 60.0
    kinds["split"] = split
    return kinds


def pmajor_groups(torch, coords, hw):
    """K6 bf16's branch for each group of GROUP consecutive pixels of each
    edge: its boxes' cells (over the four levels, rows min sy .. max sy + 7
    by columns min sx .. max sx + 7 of the padded level, the kernel's span
    starts) -> (cells [E, groups], staged [E, groups]: the group is whole
    and its boxes fit BOX_CELLS, else it gathers)."""
    E, P = coords.shape[:2]
    H2, W2 = hw
    n = -(-P // GROUP)
    idx = torch.arange(n * GROUP, device=coords.device).clamp(max=P - 1)   # past P: the last
    c = coords[:, idx].reshape(E, n, GROUP, 2)
    cells = torch.zeros(E, n, dtype=torch.long, device=coords.device)
    for l in range(4):
        Hp, Wp = (H2 >> l) + 16, (W2 >> l) + 16
        f = torch.floor(c / 2 ** l).clamp(-1e6, 1e6).long() + 8 - 3
        sx, sy = f[..., 0].clamp(0, Wp - 8), f[..., 1].clamp(0, Hp - 8)
        rows = sy.amax(-1) - sy.amin(-1) + 8
        cols = sx.amax(-1) - sx.amin(-1) + 8
        cells += rows * cols
    whole = (torch.arange(n, device=coords.device) * GROUP + GROUP <= P)[None]
    return cells, whole & (cells <= BOX_CELLS)


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
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated subset of " + ",".join(KERNELS))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("lookup_sources: no CUDA card")
    sys.path.insert(0, _REPO)
    from chip_smoke import cuda_ms, grid_sample_inputs, grid_sample_lookup, ptxas_report
    from chip_smoke import window_grid_inputs
    from droid_slam_reserch_tpu_torch.geom import coords_grid
    from droid_slam_reserch_tpu_torch.ops import build, cuda_corr
    from droid_slam_reserch_tpu_torch.ops.corr import (build_pyramid_pmajor, level_sizes,
                                                       pack_offsets, win_shape)

    chosen = args.kernels.split(",")
    texts = {}
    for s in args.src or [f"this={CSRC}"]:
        texts.update(variant_texts(*s.split("=", 1)))
    keys = {kern: [k for kk, k in texts if kk == kern] for kern in chosen}
    libs = {}
    for kern in chosen:
        paths = build_sources({k: texts[kern, k] for k in keys[kern]},
                              os.path.join(OUT, kern), KERNELS[kern][0])
        libs[kern] = {k: _load(p, kern) for k, p in paths.items()}
    report = {"ptxas": {}, "plain_cells_differ": {}, "cells_differ": {}, "ms": {},
              "k6_groups": {}}
    bad = []
    for kern in chosen:
        for k in keys[kern]:
            with open(os.path.join(OUT, kern, k, "ptxas.txt")) as f:
                lines = ptxas_report(f.read(), KERNELS[kern][2])
            report["ptxas"][f"{kern} {k}"] = lines
            for line in lines:
                print(f"[lookups] {kern} {k} ptxas: {line}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(kern, lib, dt, inputs, coords, outs, hw):
        E, P = coords.shape[:2]
        fn = getattr(lib, KERNELS[kern][1][dt == bf16])
        a = ([v.data_ptr() for v in inputs] + [coords.data_ptr(), E, P, *hw]
             + [o.data_ptr() for o in outs] + [stream])
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
            kinds = coords_kinds(torch, grid, E, gen)
            coords = kinds["random"]
            c0 = coords_kinds(torch, grid, E, gen)["random"]
            wins, bases = cuda_corr.corr_build_windows_plain(f1, f2, c0)
            padded = build_pyramid_pmajor(f1, f2, dtype=dt)[0] if "k6" in chosen else None
            c1 = (c0 + 4.0 * torch.rand(E, P, 2, generator=gen, device=dev) - 2.0).contiguous()
            del f1, f2
            # (kernel, kind of coords): (inputs, coords, the plain version's outputs)
            cases = {}
            if "k3" in chosen:
                cases["k3", "random"] = ([shifted(torch, v, offset) for v in levels], coords,
                                         (cuda_corr.corr_lookup_plain(levels, coords),))
            if "k5" in chosen:
                cases["k5", "random"] = (
                    [shifted(torch, wins, offset), bases], c1,
                    (cuda_corr.corr_lookup_windows_plain(wins, bases, c1, (H, W)),))
            if "k6" in chosen:
                pad = [shifted(torch, v, offset) for v in padded]
                for kind, cc in kinds.items():
                    cases["k6", kind] = (pad, cc,
                                         (cuda_corr.corr_lookup_pmajor_plain(padded, cc),))
                    if dt == bf16:
                        cells, staged = pmajor_groups(torch, cc, (H, W))
                        n = int(staged.sum())
                        report["k6_groups"][f"{at} {kind}"] = dict(
                            staged=n, gathered=int(staged.numel()) - n,
                            mean_cells=float(cells.float().mean()))
                        print(f"[lookups] k6 bf16 {at} {kind} coords: {n} groups staged, "
                              f"{staged.numel() - n} gathered, {float(cells.float().mean()):.1f} "
                              f"box cells a group", flush=True)
            if "k7" in chosen:
                cases["k7", "random"] = ([shifted(torch, v, offset) for v in levels], c0,
                                         cuda_corr.corr_extract_windows_plain(levels, c0))
            for (kern, kind), (inputs, cc, plain) in cases.items():
                ref = None
                for k in keys[kern]:
                    if (kern, k.rpartition("-")[2]) in PHASES:
                        continue
                    outs = [torch.empty_like(v) for v in plain]
                    launcher(kern, libs[kern][k], dt, inputs, cc, outs, (H, W))()
                    torch.cuda.synchronize()
                    what = f"{kern} {dt} {at}" + ("" if kind == "random" else f" {kind}")
                    differ = sum(int((o != v).sum()) for o, v in zip(outs, plain))
                    err = max(float((o.float() - v.float()).abs().max())
                              for o, v in zip(outs, plain))
                    report["plain_cells_differ"][f"{k} {what}"] = differ
                    if differ and not (kern == "k5" and dt == f32):   # fp32 K5 takes FMAs
                        bad.append(f"{k} {what} against the plain version")
                    line = (f"[lookups] {what}: {k} against the plain version {differ} cells "
                            f"differ (max {err:.3e})")
                    if ref is None:
                        ref = outs
                    else:
                        same = sum(int((o != r).sum()) for o, r in zip(outs, ref))
                        report["cells_differ"][f"{keys[kern][0]}/{k} {what}"] = same
                        if same:
                            bad.append(f"{k} {what} against {keys[kern][0]}")
                        line += f", against {keys[kern][0]} {same} cells differ"
                    print(line, flush=True)
                del ref, outs
            if (E, H, W, offset) in TIMED:
                reps = 40 if E > 1 else 200
                sizes = level_sizes(H, W)
                views = [wins[:, :, o:o + win_shape(*hw)[0], :win_shape(*hw)[1]]
                         for o, hw in zip(pack_offsets(sizes)[0], sizes)]
                # the library call of each timed case, and its grid_sample mode
                gs = {("k3", "random"): (grid_sample_inputs(torch, levels, coords), "bilinear"),
                      ("k5", "random"): (grid_sample_inputs(torch, views, c1, bases), "bilinear"),
                      ("k6", "random"): (grid_sample_inputs(torch, levels, coords), "bilinear"),
                      ("k6", "pan4"): (grid_sample_inputs(torch, levels, kinds["pan4"]),
                                       "bilinear"),
                      ("k7", "random"): (window_grid_inputs(torch, levels, bases), "nearest")}
                g = outs = None
                for (kern, kind), (inputs, cc, plain) in cases.items():
                    if (kern, kind) not in gs:
                        continue
                    what = f"{kern} {{}} {dt} {at}" + ("" if kind == "random" else f" {kind}")
                    outs = [torch.empty_like(v) for v in plain]
                    for k in keys[kern] + keys[kern][::-1]:
                        ms = cuda_ms(torch, launcher(kern, libs[kern][k], dt, inputs, cc, outs,
                                                     (H, W)), reps)
                        report["ms"].setdefault(what.format(k), []).append(ms)
                        print(f"[lookups] {what.format(k)}: {ms:.4f} ms", flush=True)
                    g, mode = gs[kern, kind]
                    g = [(v, x.to(dt)) for v, x in g]
                    align = mode == "bilinear"
                    ms = cuda_ms(torch, lambda: grid_sample_lookup(torch, g, mode, align), reps)
                    report["ms"][what.format(f"F.grid_sample {mode}")] = [ms]
                    print(f"[lookups] {what.format(f'F.grid_sample {mode} x4')}: {ms:.4f} ms",
                          flush=True)
                del gs, g, views, outs
            del levels, wins, bases, padded, cases, plain
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    report["card"] = smi
    os.makedirs(os.path.dirname(REPORT), exist_ok=True)
    with open(REPORT, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[lookups] the report: {REPORT}", flush=True)
    if bad:
        sys.exit(f"lookup_sources: cells differ: {bad}")


if __name__ == "__main__":
    main()
