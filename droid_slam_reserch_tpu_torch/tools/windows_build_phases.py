"""Where the bf16 window-cache build's time goes: K4 bf16 and K8 bf16
(csrc/corr_windows_build.cu) timed whole and with phases taken out.

    python -m droid_slam_reserch_tpu_torch.tools.windows_build_phases
    python -m droid_slam_reserch_tpu_torch.tools.windows_build_phases \\
        --src parent=build/parent/droid_slam_reserch_tpu_torch/csrc/corr_windows_build.cu \\
        --src change=droid_slam_reserch_tpu_torch/csrc/corr_windows_build.cu

Each variant is a copy of the source with a few lines of its bf16 kernel
edited (the kernel of its own, or in an older source the template that it
shares with fp32), written under ``build/windows_build_phases/`` and built
by nvcc into a library of its own (one process a variant, all started
together); the committed source carries no switch.  The variants:

    a  the kernel as it is
    b  without the window and level stores: each block returns once its
       band is pooled, after thread 0 writes one word of its tile
    c  without the mma.sync products: each product is replaced by a few
       integer operations on the same fragments, so the fragment loads stay
    e  the loads and the products alone: each block returns after the
       mainloop of its first column chunk (one value written)
    d  the loads alone: the cp.async stages of e, with no fragment loads
       and no products
    f  K8 without its level stores (K4 is a's)

Edits that jump over a phase test ``m.nbands`` at run time, which the
compiler cannot fold, so the skipped code is still compiled.  Each
variant's K4 bf16 (and, for a, c and f, K8 bf16) is timed by chip_smoke's
cuda_ms (CUDA events around launches held behind a sleep kernel) at bench.py's
shape (E = 48 edges, 40x64, C = 128), in the order src1, src2, ...,
src2, src1, and each source's kernel as it is is held against the plain
version; with two sources the two kernels' outputs are compared bit for
bit on the same inputs.  Runs on the card only; prints one line a
measurement and a JSON line of all of them.
"""
import argparse
import ctypes
import glob
import json
import os
import shutil
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "droid_slam_reserch_tpu_torch", "csrc", "corr_windows_build.cu")
OUT = os.path.join(_REPO, "build", "windows_build_phases")

# one value a block, read from the start of its shared memory, so that the
# work before it is kept (into bases, an int in every kernel)
_ONE_VALUE = ("if (m.nbands > 0) {{ if (tid == 0) bases[(blockIdx.z * gridDim.y + blockIdx.y) "
              "* gridDim.x + blockIdx.x] = *reinterpret_cast<const int*>(smem4); return; }}\n"
              "{indent}")
_FAKE_MMA = """
// integer work on the fragments of an m16n8k16 product, in its place
__device__ __forceinline__ void fake_mma(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  d[0] = __uint_as_float((__float_as_uint(d[0]) ^ a[0] ^ b[0]) & 0x3f7fffffu);
  d[1] = __uint_as_float((__float_as_uint(d[1]) ^ a[1] ^ b[1]) & 0x3f7fffffu);
  d[2] = __uint_as_float((__float_as_uint(d[2]) ^ a[2]) & 0x3f7fffffu);
  d[3] = __uint_as_float((__float_as_uint(d[3]) ^ a[3]) & 0x3f7fffffu);
}
"""
# the lines each edit finds in the kernel that holds the bf16 products
_STORES = "  const bool first = band == 0, last = band == m.nbands - 1;"
_MAINLOOP_END = "    cp_async_wait<0>();\n    __syncthreads();"
# the products' guard: in a bf16 kernel of its own, or in a template shared with fp32
_BF16_PRODUCTS = ("      cp_async_commit();\n      if (live) {",
                  "if constexpr (sizeof(Elem) == 2) {\n        if (live) {")
_LEVEL_STORES = "      if constexpr (kStoreLevels) {"


def _edit(text, old, new, count=None):
    n = text.count(old)
    if n == 0 or (count is not None and n != count):
        raise ValueError(f"the kernel has {n} copies of {old!r}")
    return text.replace(old, new)


def _stop_after_mainloop(body):
    return _edit(body, _MAINLOOP_END,
                 _MAINLOOP_END + "\n    " + _ONE_VALUE.format(indent="    ").rstrip(), 1)


def _loads_alone(body):
    old = next((o for o in _BF16_PRODUCTS if o in body), _BF16_PRODUCTS[0])
    return _edit(_stop_after_mainloop(body), old,
                 old.replace("(live)", "(live && m.nbands < 0)"), 1)


VARIANTS = {      # each edits the body of the kernel that holds the bf16 products
    "a": lambda b: b,
    "b": lambda b: _edit(b, _STORES, "  " + _ONE_VALUE.format(indent="") + _STORES, 1),
    "c": lambda b: _edit(b, "mma_bf16(acc", "fake_mma(acc"),
    "e": _stop_after_mainloop,
    "d": _loads_alone,
    "f": lambda b: _edit(b, _LEVEL_STORES, _LEVEL_STORES.replace("{", "if (m.nbands < 0) {"), 1),
}
WITH_LEVELS = ("a", "c", "f")    # variants whose K8 is timed too


def bf16_kernel(text):
    """(start, end) of the body of the kernel with the bf16 products: the
    bf16 kernel of its own, else a template that it shares with fp32."""
    for name in ("windows_build_bf16_kernel(", "windows_build_kernel("):
        i = text.find(name)
        if i >= 0:
            j = text.index("\n}\n", i)
            if "mma_bf16(acc" in text[i:j]:
                return i, j
    raise ValueError("no kernel of the source takes bf16 products")


def variant_sources(text, names=tuple(VARIANTS)):
    """{variant: edited source text}; raises ValueError where an edit does
    not find its line in the bf16 kernel exactly as often as it expects."""
    i, j = bf16_kernel(text)
    out = {}
    for v in names:
        head = _edit(text[:i], "namespace {\n", "namespace {\n" + _FAKE_MMA, 1) if v == "c" \
            else text[:i]
        out[v] = head + VARIANTS[v](text[i:j]) + text[j:]
    return out


def build_sources(texts, out_dir, filename):
    """nvcc-build {key: (source text, directory of its headers)}, one process
    a source, all started together, each as ``<out_dir>/<key>/<filename>``
    beside a copy of its directory's headers (``*.cuh``) into
    ``<key>/lib.so`` -> {key: .so path}, with each build's ptxas report in
    ``<key>/ptxas.txt``."""
    from droid_slam_reserch_tpu_torch.ops import build

    nvcc = build._nvcc()
    procs = {}
    for key, (text, header_dir) in texts.items():
        d = os.path.join(out_dir, key)
        os.makedirs(d, exist_ok=True)
        for header in glob.glob(os.path.join(header_dir, "*.cuh")):
            shutil.copy(header, d)
        src = os.path.join(d, filename)
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(d, "lib.so")
        cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", lib, src]
        procs[key] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        with open(os.path.join(os.path.dirname(lib), "ptxas.txt"), "w") as f:
            f.write(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {key}:\n{out}")
        libs[key] = lib
    return libs


def build_variants(sources, out_dir=OUT):
    """Write and nvcc-build every (source name, variant) -> {key: .so path},
    with each build's ptxas report in ``<key>/ptxas.txt``."""
    texts = {}
    for name, path in sources.items():
        with open(path) as f:
            text = f.read()
        for v, edited in variant_sources(text).items():
            texts[f"{name}-{v}"] = (edited, os.path.dirname(path))
    return build_sources(texts, out_dir, "corr_windows_build.cu")


def _load(path):
    from droid_slam_reserch_tpu_torch.ops import build

    lib = ctypes.CDLL(path)
    for name in ("corr_windows_build_bf16_launch", "corr_windows_build_levels_bf16_launch"):
        getattr(lib, name).argtypes = build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", default=[],
                    help="NAME=PATH of a corr_windows_build.cu (default: this checkout's)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("windows_build_phases: no CUDA card")
    sys.path.insert(0, _REPO)
    from chip_smoke import cuda_ms
    from droid_slam_reserch_tpu_torch.geom import coords_grid
    from droid_slam_reserch_tpu_torch.ops import build, cuda_corr

    sources = dict(s.split("=", 1) for s in args.src) or {"this": SOURCE}
    libs = {k: _load(p) for k, p in build_variants(sources).items()}
    E, H, W, C = 48, 40, 64, 128
    P = H * W
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    f1 = (0.3 * torch.randn(E, H, W, C, generator=gen, device=dev)).to(torch.bfloat16)
    f2 = (0.3 * torch.randn(E, H, W, C, generator=gen, device=dev)).to(torch.bfloat16)
    grid = coords_grid(H, W, device=dev).reshape(1, P, 2)
    c0 = (grid + 2.0 * torch.randn(E, P, 2, generator=gen, device=dev)).contiguous()
    c0[:, :64] += 50.0
    pwins, pbases = cuda_corr.corr_build_windows_plain(f1, f2, c0)
    plevels = cuda_corr.corr_build_windows_levels_plain(f1, f2, c0)[0]
    wins, bases = torch.empty_like(pwins), torch.empty_like(pbases)
    levels = [torch.empty_like(v) for v in plevels]
    stream = torch.cuda.current_stream().cuda_stream
    shape = (E, P, H, W, C)

    def k4(lib):
        return lambda: build.check(lib.corr_windows_build_bf16_launch(
            f1.data_ptr(), f2.data_ptr(), c0.data_ptr(), *shape, wins.data_ptr(),
            bases.data_ptr(), stream), "K4 bf16")

    def k8(lib):
        return lambda: build.check(lib.corr_windows_build_levels_bf16_launch(
            f1.data_ptr(), f2.data_ptr(), c0.data_ptr(), *shape, wins.data_ptr(),
            bases.data_ptr(), *[v.data_ptr() for v in levels], stream), "K8 bf16")

    # each source's kernel as it is, against the plain version and the others
    outs, report = {}, {"shape": [E, H, W, C]}
    tol = 2.0 ** -7 * float(plevels[0].float().abs().max())      # one bf16 rounding step
    for name in sources:
        k4(libs[f"{name}-a"])()
        torch.cuda.synchronize()
        w4 = wins.clone()
        k8(libs[f"{name}-a"])()
        torch.cuda.synchronize()
        outs[name] = (w4, wins.clone(), [v.clone() for v in levels])
        err = max([float((w4.float() - pwins.float()).abs().max())]
                  + [float((a.float() - b.float()).abs().max()) for a, b in zip(levels, plevels)])
        ok = bool((bases == pbases).all()) and err <= tol
        print(f"[phases] {name}: K4/K8 bf16 against the plain version {err:.3e} (tol {tol:.1e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            sys.exit(f"{name}'s kernel disagrees with the plain version")
        report[f"{name}_max_abs_err"] = err
    names = list(sources)
    for other in names[1:]:
        a, b = outs[names[0]], outs[other]
        same = {"k4_windows": torch.equal(a[0], b[0]), "k8_windows": torch.equal(a[1], b[1]),
                "k8_levels": all(torch.equal(x, y) for x, y in zip(a[2], b[2]))}
        differ = int((a[0] != b[0]).sum())
        print(f"[phases] {names[0]} against {other}, bit for bit: {same} "
              f"({differ} K4 window cells differ)", flush=True)
        report[f"bit_equal_{names[0]}_{other}"] = dict(same, k4_cells_differ=differ)
    del outs, pwins, pbases, plevels

    times = {}
    for name in names + names[::-1]:
        for v in VARIANTS:
            lib = libs[f"{name}-{v}"]
            runs = [("k4", k4(lib))] + ([("k8", k8(lib))] if v in WITH_LEVELS else [])
            for kern, fn in runs:
                ms = cuda_ms(torch, fn, 20)
                times.setdefault(f"{name}-{v}-{kern}", []).append(ms)
                print(f"[phases] {name} {v} {kern} bf16 E={E}: {ms:.4f} ms", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    report.update(card=smi, ms=times)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
