"""K2 (csrc/corr_build.cu) built from several sources and compared in one run:
fp32 K2 and both bf16 instantiations (bf16 levels, fp32 levels).

    python -m droid_slam_reserch_tpu_torch.tools.corr_build_sources \\
        --src parent=build/parent/droid_slam_reserch_tpu_torch/csrc/corr_build.cu \\
        --src change=droid_slam_reserch_tpu_torch/csrc/corr_build.cu

Each source is built by nvcc into a library of its own under
``build/corr_build_sources/`` (windows_build_phases' build helper, one
process a library, all started together), and so is each variant whose
line the source holds; the committed source carries no switch:

    one_tile    the bf16-levels kernel launched with one block a tile, so no
                tile's loads run under another tile's epilogue
    contiguous  its persistent blocks each take a contiguous range of tiles
                (block b the b-th range) instead of tiles b, b + G, ...
    stages3     its ring with 3 stages instead of 2

Each library's kernels are held against the plain versions, and their
levels compared bit for bit with the first library's, at E = 48, 1 and 64
over 40x64 and at chip_smoke's ragged shapes; then each is timed by
chip_smoke's cuda_ms at E = 48, 1 and 64 over 40x64 (C = 128) in the order
lib1, lib2, ..., lib2, lib1, beside torch.bmm of the volume in fp32, in bf16
and from bf16 to fp32 (``out_dtype``).  Runs on the card only; prints the
K2 kernels' ptxas lines, one line a measurement and a JSON line of all.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

from .windows_build_phases import build_sources

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "droid_slam_reserch_tpu_torch", "csrc", "corr_build.cu")
OUT = os.path.join(_REPO, "build", "corr_build_sources")

VARIANTS = {       # name: (the line of the bf16 kernel's source, its replacement)
    "one_tile": ("sc->blocks = sc->tiles < sms ? sc->tiles : sms;", "sc->blocks = sc->tiles;"),
    "contiguous": ("tile_at((int)blockIdx.x + k * (int)gridDim.x, nblk, nm, ncols);",
                   "tile_at((int)blockIdx.x * per + min((int)blockIdx.x, extra) + k, nblk, nm, "
                   "ncols);"),
    "stages3": ("constexpr int kStages16 = 2;", "constexpr int kStages16 = 3;"),
}
# (E, H, W): the timed shapes first, then chip_smoke's ragged ones
TIMED = [(48, 40, 64), (1, 40, 64), (64, 40, 64)]
RAGGED = [(4, 30, 44), (2, 60, 80), (2, 48, 120), (2, 30, 45), (2, 24, 34), (2, 24, 66)]
C = 128
KERNELS = ("corr_build", "corr_build_bf16", "corr_build_bf16_f32")


def variant_texts(name, path):
    """{key: (text, header directory)}: the source as it is under `name`, and
    each variant whose line it holds exactly once under `name-variant`."""
    with open(path) as f:
        text = f.read()
    out = {name: (text, os.path.dirname(path))}
    for v, (old, new) in VARIANTS.items():
        if text.count(old) == 1:
            out[f"{name}-{v}"] = (text.replace(old, new), os.path.dirname(path))
    return out


def _load(path):
    from droid_slam_reserch_tpu_torch.ops import build

    lib = ctypes.CDLL(path)
    for name in ("corr_build_launch", "corr_build_bf16_launch"):
        getattr(lib, name).argtypes = build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", default=[],
                    help="NAME=PATH of a corr_build.cu (default: this checkout's)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("corr_build_sources: no CUDA card")
    sys.path.insert(0, _REPO)
    from chip_smoke import BF16, cuda_ms, ptxas_report
    from droid_slam_reserch_tpu_torch.ops import build, cuda_corr

    texts = {}
    for s in args.src or [f"this={SOURCE}"]:
        texts.update(variant_texts(*s.split("=", 1)))
    paths = build_sources(texts, OUT, "corr_build.cu")
    libs = {k: _load(p) for k, p in paths.items()}
    keys = list(libs)
    report = {"ptxas": {}, "held": {}, "bit_equal": {}, "ms": {}}
    for k in keys:
        with open(os.path.join(OUT, k, "ptxas.txt")) as f:
            lines = ptxas_report(f.read(), ("corr_build_kernel", "corr_build_bf16_kernel"))
        report["ptxas"][k] = lines
        for line in lines:
            print(f"[k2] {k} ptxas: {line}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(lib, name, f1, f2, levels):
        E, H, W, _ = f1.shape
        a = (f1.data_ptr(), f2.data_ptr(), E, H * W, H, W, C, *[v.data_ptr() for v in levels])
        if name == "corr_build":
            return lambda: build.check(lib.corr_build_launch(*a, stream), name)
        return lambda: build.check(
            lib.corr_build_bf16_launch(*a, int(name == "corr_build_bf16_f32"), stream), name)

    for E, H, W in TIMED + RAGGED:
        at = f"E={E} {H}x{W}"
        f1 = torch.randn(E, H, W, C, generator=gen, device=dev)
        f2 = torch.randn(E, H, W, C, generator=gen, device=dev)
        f1h, f2h = (0.3 * f1).to(bf16), (0.3 * f2).to(bf16)
        for name in KERNELS:
            feats = (f1, f2) if name == "corr_build" else (f1h, f2h)
            out_dtype = bf16 if name == "corr_build_bf16" else f32
            plain = cuda_corr.corr_build_plain(*feats, out_dtype)
            scale = float(plain[0].float().abs().max())
            tol = BF16 * scale if out_dtype == bf16 else 1e-5 * max(1.0, scale)
            ref = None
            for k in keys:
                levels = [torch.empty_like(v) for v in plain]
                launcher(libs[k], name, *feats, levels)()
                torch.cuda.synchronize()
                err = max(float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
                          for a, b in zip(levels, plain))
                report["held"][f"{k} {name} {at}"] = err
                if not err <= tol:
                    sys.exit(f"{k}'s {name} disagrees with the plain version at {at}: "
                             f"{err:.3e} > {tol:.1e}")
                if ref is None:
                    ref = levels
                    continue
                differ = sum(int((a != b).sum()) for a, b in zip(levels, ref))
                report["bit_equal"][f"{keys[0]}/{k} {name} {at}"] = differ
                print(f"[k2] {name} {at}: {k} against {keys[0]}: {differ} cells differ "
                      f"(plain {err:.3e}, tol {tol:.1e})", flush=True)
            del ref, levels, plain
        if (E, H, W) not in TIMED:
            continue
        reps = 50 if E == 1 else 10
        a, b = f1.reshape(E, H * W, C), f2.reshape(E, H * W, C).transpose(1, 2)
        ah, bh = f1h.reshape(E, H * W, C), f2h.reshape(E, H * W, C).transpose(1, 2)
        lib_calls = {"bmm fp32": lambda: torch.bmm(a, b), "bmm bf16": lambda: torch.bmm(ah, bh),
                     "bmm bf16 -> fp32": lambda: torch.bmm(ah, bh, out_dtype=f32)}
        outs = {name: [torch.empty(E, H * W, H >> l, W >> l, device=dev,
                                   dtype=bf16 if name == "corr_build_bf16" else f32)
                       for l in range(4)] for name in KERNELS}
        for k in keys + keys[::-1]:
            for name in KERNELS:
                feats = (f1, f2) if name == "corr_build" else (f1h, f2h)
                ms = cuda_ms(torch, launcher(libs[k], name, *feats, outs[name]), reps)
                report["ms"].setdefault(f"{k} {name} {at}", []).append(ms)
                print(f"[k2] {k} {name} {at}: {ms:.4f} ms", flush=True)
            for lname, fn in lib_calls.items():
                ms = cuda_ms(torch, fn, reps)
                report["ms"].setdefault(f"{lname} {at}", []).append(ms)
                print(f"[k2] {lname} {at}: {ms:.4f} ms", flush=True)
        del outs, f1, f2, f1h, f2h, a, b, ah, bh
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    report["card"] = smi
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
