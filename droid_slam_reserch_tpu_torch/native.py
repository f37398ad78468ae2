"""Host graph helpers: Schur bucket tables, edge dedup, and the greedy
proximity edge selection with non-maximum suppression.

``proximity_select``, ``dedup_edges`` and ``bucket_tables`` (through
``schur_buckets``) call the port's C++ library, ``csrc/graph_ops.cpp`` (a
copy of the JAX package's native/graph_ops.cpp), so that the port selects
the JAX package's edges, also where distances tie.  The library is built
with the host compiler (``g++ -O3 -std=c++17 -fPIC -shared``) at first use
into ``build/torch_host/``, and again when the source is newer; nothing is
compiled at import.  A build that fails raises with the compiler's output:
no path falls back to numpy.

The numpy versions (``proximity_select_plain``, ``dedup_edges_plain``,
``bucket_tables_plain``) are the library's plain versions, for the tests and
chip_smoke.py; no engine path calls them.  They give the library's results
wherever no two distances tie (``np.argsort`` and ``std::sort`` order equal
keys differently, and the greedy NMS then keeps other edges).  ``counts()``
gives every entry point's library calls and its plain version's calls, as
``ops.counts()`` does for the kernels.
"""
import ctypes
import os
import subprocess
import threading

import numpy as np

from .ba.solver import schur_pairs

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_REPO, "droid_slam_reserch_tpu_torch", "csrc", "graph_ops.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "torch_host")
LIB_PATH = os.path.join(BUILD_DIR, "libgraphops.so")
CXX = ["g++", "-O3", "-std=c++17", "-fPIC", "-shared"]

_lib = None
_lock = threading.Lock()

NAMES = ("proximity_select", "dedup_edges", "bucket_tables")
calls = dict.fromkeys(NAMES, 0)
plain_calls = dict.fromkeys(NAMES, 0)


def reset_counts():
    """Set every entry point's library and plain-version call count to 0."""
    calls.update(dict.fromkeys(NAMES, 0))
    plain_calls.update(dict.fromkeys(NAMES, 0))


def counts():
    """{entry point: (library calls, plain-version calls)}."""
    return {name: (calls[name], plain_calls[name]) for name in NAMES}


def build():
    """Compile the library if it is missing or older than its source;
    returns its path.  The compiler writes a name of this process's own and
    the result is renamed into place, so that processes building at once
    never load a half-written library."""
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = CXX + ["-o", tmp, SOURCE]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building the graph library failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building the graph library failed ({' '.join(cmd)}, exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
            lib.schur_buckets.restype = ctypes.c_int
            lib.schur_buckets.argtypes = [i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p,
                                          u8p]
            lib.proximity_select.restype = ctypes.c_int
            lib.proximity_select.argtypes = [
                f64p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_double, ctypes.c_longlong, ctypes.c_int,
                i32p, i32p, ctypes.c_int, ctypes.c_int, i32p, i32p, ctypes.c_int,
            ]
            lib.dedup_edges.restype = None
            lib.dedup_edges.argtypes = [i64p, i64p, ctypes.c_int, i64p, i64p, ctypes.c_int, u8p]
            _lib = lib
        return _lib


def have_native():
    """Build and load the library: True, or the build's error raised."""
    return _load() is not None


def schur_buckets(ii, num_buckets, R):
    """Bucket tables of width R: (edges [M, R] int32, mask [M, R] bool, max degree)."""
    lib = _load()
    ii = np.ascontiguousarray(ii, np.int32)
    edges = np.zeros((num_buckets, R), np.int32)
    mask = np.zeros((num_buckets, R), np.uint8)
    max_deg = lib.schur_buckets(ii, len(ii), num_buckets, R, edges, mask.reshape(-1))
    return edges, mask.astype(bool), int(max_deg)


def _round_degree(ii, num_buckets, round_to):
    valid = ii[(ii >= 0) & (ii < num_buckets)]
    max_deg = int(np.bincount(valid, minlength=num_buckets).max()) if len(valid) else 1
    return ((max(max_deg, 1) + 1 + round_to - 1) // round_to) * round_to - 1


def bucket_tables(ii, num_buckets, round_to=4):
    """Schur bucket tables with the max degree rounded up.

    Returns (edges [M, R] int32, mask [M, R] bool).
    """
    calls["bucket_tables"] += 1
    ii = np.asarray(ii, np.int32)
    edges, mask, _ = schur_buckets(ii, num_buckets, _round_degree(ii, num_buckets, round_to))
    return edges, mask


def bucket_tables_plain(ii, num_buckets, round_to=4):
    """bucket_tables in numpy."""
    plain_calls["bucket_tables"] += 1
    ii = np.asarray(ii, np.int32)
    return schur_pairs(ii, num_buckets, max_deg=_round_degree(ii, num_buckets, round_to))


def dedup_edges(ii, jj, ex_i, ex_j):
    """Keep mask for edges not already in (ex_i, ex_j)."""
    calls["dedup_edges"] += 1
    lib = _load()
    ii = np.ascontiguousarray(ii, np.int64)
    jj = np.ascontiguousarray(jj, np.int64)
    ex_i = np.ascontiguousarray(ex_i, np.int64)
    ex_j = np.ascontiguousarray(ex_j, np.int64)
    keep = np.zeros(len(ii), np.uint8)
    lib.dedup_edges(ii, jj, len(ii), ex_i, ex_j, len(ex_i), keep)
    return keep.astype(bool)


def dedup_edges_plain(ii, jj, ex_i, ex_j):
    """dedup_edges in numpy."""
    plain_calls["dedup_edges"] += 1
    eset = set(zip(np.asarray(ex_i).tolist(), np.asarray(ex_j).tolist()))
    return np.array([(i, j) not in eset for i, j in zip(np.asarray(ii).tolist(),
                                                          np.asarray(jj).tolist())], bool)


def proximity_select(d, t0, t1, t, rad, nms, thresh, max_factors, ex_i, ex_j, stereo):
    """Greedy thresholded edge selection (reference factor_graph.py:315-379).

    d: [t - t0, t - t1] frame distances; ex_i/ex_j: existing edges (active,
    bad, inactive) to suppress around.  Returns (ii, jj) int64 arrays.
    """
    calls["proximity_select"] += 1
    lib = _load()
    d = np.array(d, np.float64).reshape(-1)              # a copy: the library writes it
    ex_i = np.ascontiguousarray(ex_i, np.int32)
    ex_j = np.ascontiguousarray(ex_j, np.int32)
    cap = 4 * (t - t0) * max(rad + 2, 2) + 2 * len(d) // max(t - t0, 1) + 4096
    out_i = np.zeros(cap, np.int32)
    out_j = np.zeros(cap, np.int32)
    m = lib.proximity_select(d, t0, t1, t, rad, nms, float(thresh), int(max_factors), 0,
                             ex_i, ex_j, len(ex_i), int(stereo), out_i, out_j, cap)
    return out_i[:m].astype(np.int64), out_j[:m].astype(np.int64)


def proximity_select_plain(d, t0, t1, t, rad, nms, thresh, max_factors, ex_i, ex_j, stereo):
    """proximity_select in numpy (ties ordered by np.argsort)."""
    plain_calls["proximity_select"] += 1
    ix = np.arange(t0, t)
    jx = np.arange(t1, t)
    ii, jj = np.meshgrid(ix, jx, indexing="ij")
    d = np.array(d, np.float64).reshape(-1)
    ii = ii.reshape(-1)
    jj = jj.reshape(-1)

    d[ii - rad < jj] = np.inf
    d[d > 100] = np.inf

    def suppress(i, j):
        for di in range(-nms, nms + 1):
            for dj in range(-nms, nms + 1):
                if abs(di) + abs(dj) <= max(min(abs(i - j) - 2, nms), 0):
                    i1, j1 = i + di, j + dj
                    if (t0 <= i1 < t) and (t1 <= j1 < t):
                        d[(i1 - t0) * (t - t1) + (j1 - t1)] = np.inf

    for i, j in zip(np.asarray(ex_i).tolist(), np.asarray(ex_j).tolist()):
        suppress(i, j)

    es = []
    for i in range(t0, t):
        if stereo:
            es.append((i, i))
            if t1 <= i:
                d[(i - t0) * (t - t1) + (i - t1)] = np.inf
        for j in range(max(i - rad - 1, 0), i):
            es.append((i, j))
            es.append((j, i))
            if t1 <= j < t:
                d[(i - t0) * (t - t1) + (j - t1)] = np.inf

    for k in np.argsort(d):
        if d[k] > thresh:
            break
        if max_factors > 0 and len(es) > max_factors:
            break
        i, j = int(ii[k]), int(jj[k])
        es.append((i, j))
        es.append((j, i))
        suppress(i, j)

    es = np.asarray(es, np.int64).reshape(-1, 2)
    return es[:, 0], es[:, 1]
