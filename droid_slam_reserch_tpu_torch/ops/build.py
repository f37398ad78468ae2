"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` source is compiled for ``sm_90a`` by its own nvcc
process, all started together, and the objects are linked into one shared
library with a plain C interface under ``build/torch_kernels/`` (listed in
``.gitignore``).  The build runs at first use and again whenever a source or
a header (``csrc/*.cuh``) is newer than the library; nothing is imported or
compiled at module import.
"""
import ctypes
import glob
import os
import shutil
import subprocess
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_REPO, "droid_slam_reserch_tpu_torch", "csrc")
BUILD_DIR = os.path.join(_REPO, "build", "torch_kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libdroid_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lib = None
BUILD_LOG = {"seconds": None, "ptxas": ""}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "ba_blocks_launch": [_P] * 7 + [_F] * 2 + [_I] * 3 + [_P] * 6,
    "corr_build_launch": [_P, _P] + [_I] * 5 + [_P] * 5,
    "corr_build_bf16_launch": [_P, _P] + [_I] * 5 + [_P] * 4 + [_I, _P],
    "corr_lookup_launch": [_P] * 5 + [_I] * 4 + [_P, _P],
    "corr_lookup_bf16_launch": [_P] * 5 + [_I] * 4 + [_P, _P],
    "corr_windows_build_launch": [_P] * 3 + [_I] * 5 + [_P] * 3,
    "corr_windows_build_bf16_launch": [_P] * 3 + [_I] * 5 + [_P] * 3,
    "corr_windows_lookup_launch": [_P] * 3 + [_I] * 4 + [_P, _P],
    "corr_windows_lookup_bf16_launch": [_P] * 3 + [_I] * 4 + [_P, _P],
    "corr_pmajor_lookup_launch": [_P] * 5 + [_I] * 4 + [_P, _P],
    "corr_pmajor_lookup_bf16_launch": [_P] * 5 + [_I] * 4 + [_P, _P],
    "corr_extract_windows_launch": [_P] * 5 + [_I] * 4 + [_P] * 3,
    "corr_extract_windows_bf16_launch": [_P] * 5 + [_I] * 4 + [_P] * 3,
    "corr_windows_build_levels_launch": [_P] * 3 + [_I] * 5 + [_P] * 7,
    "corr_windows_build_levels_bf16_launch": [_P] * 3 + [_I] * 5 + [_P] * 7,
    "corr_windows_build_info": [_I, _I, _P],
    "corr_build_info": [_P],
    "corr_build_bf16_info": [_I] * 4 + [_P],
    "conv3x3_launch": [_P] + [_I] * 4 + [ctypes.c_longlong] + [_P] * 3 + [_I] * 2 + [_P] * 2,
    "conv3x3_info": [_I, _P],
}


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def _stale(sources):
    if not os.path.exists(LIB_PATH):
        return True
    t = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > t for s in sources)


def build(ptxas_verbose=False):
    """Compile every source in parallel and link the library; returns its path.

    With ptxas_verbose, ``BUILD_LOG["ptxas"]`` holds the register, shared
    memory and spill report of every kernel.
    """
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    extra = ["-Xptxas", "-v"] if ptxas_verbose else []
    procs = []
    for src in sources:
        obj = os.path.join(BUILD_DIR, os.path.basename(src)[:-3] + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {os.path.basename(src)}:\n{out}")
    tmp = LIB_PATH + f".{os.getpid()}.tmp"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
                           *[obj for _, obj, _ in procs]],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, LIB_PATH)
    BUILD_LOG["seconds"] = time.time() - t0
    BUILD_LOG["ptxas"] = "".join(logs)
    return LIB_PATH


def library():
    """The loaded kernel library, built first if it is missing or stale."""
    global _lib
    if _lib is None:
        sources = glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh"))
        if _stale(sources):
            build()
        lib = ctypes.CDLL(LIB_PATH)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err, name):
    """Raise if a launch function returned a nonzero cudaGetLastError()."""
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError {err}")
