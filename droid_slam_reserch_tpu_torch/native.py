"""Host graph helpers in numpy: Schur bucket tables, edge dedup, and the
greedy proximity edge selection with non-maximum suppression.

The port's own copies of the JAX package's numpy paths (native.py and the
Python NMS of factor_graph.add_proximity_factors); they give the same edges
as the JAX package's C++ library.
"""
import numpy as np

from .ba.solver import schur_pairs


def bucket_tables(ii, num_buckets, round_to=4):
    """Schur bucket tables with the max degree rounded up.

    Returns (edges [M, R] int32, mask [M, R] bool).
    """
    ii = np.asarray(ii, np.int32)
    valid = ii[(ii >= 0) & (ii < num_buckets)]
    max_deg = int(np.bincount(valid, minlength=num_buckets).max()) if len(valid) else 1
    R = ((max(max_deg, 1) + 1 + round_to - 1) // round_to) * round_to - 1
    return schur_pairs(ii, num_buckets, max_deg=R)


def dedup_edges(ii, jj, ex_i, ex_j):
    """Keep mask for edges not already in (ex_i, ex_j)."""
    eset = set(zip(np.asarray(ex_i).tolist(), np.asarray(ex_j).tolist()))
    return np.array([(i, j) not in eset for i, j in zip(np.asarray(ii).tolist(),
                                                          np.asarray(jj).tolist())], bool)


def proximity_select(d, t0, t1, t, rad, nms, thresh, max_factors, ex_i, ex_j, stereo):
    """Greedy thresholded edge selection (reference factor_graph.py:315-379).

    d: [t - t0, t - t1] frame distances; ex_i/ex_j: existing edges (active,
    bad, inactive) to suppress around.  Returns (ii, jj) int64 arrays.
    """
    ix = np.arange(t0, t)
    jx = np.arange(t1, t)
    ii, jj = np.meshgrid(ix, jx, indexing="ij")
    d = np.asarray(d).reshape(-1).astype(np.float64)
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
