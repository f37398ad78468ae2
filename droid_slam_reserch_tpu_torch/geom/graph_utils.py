"""Covisibility graph helpers (mirror of geom/graph_utils.py): the
neighbourhood graph of the engine, and the training graph built from a
flow-distance matrix."""
from collections import OrderedDict

import numpy as np


def graph_to_edge_list(graph):
    """Graph dict {u: [v, ...]} -> (ii, jj, kk) int32 arrays, kk the index of u."""
    ii, jj, kk = [], [], []
    for s, u in enumerate(graph):
        for v in graph[u]:
            ii.append(u)
            jj.append(v)
            kk.append(s)
    return (np.asarray(ii, dtype=np.int32), np.asarray(jj, dtype=np.int32),
            np.asarray(kk, dtype=np.int32))


def keyframe_indicies(graph):
    return np.asarray([u for u in graph], dtype=np.int32)


def neighbourhood_graph(n, r, c=0):
    """All ordered pairs with c < |i-j| <= r.  c = 0 gives every pair within
    r (the JAX package's neighbourhood_graph); the stereo frontend passes
    c = 1, which also drops the |i-j| = 1 pairs, as the JAX FactorGraph's
    add_neighborhood_factors does (engine/factor_graph.py:1158-1164)."""
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    d = np.abs(ii - jj)
    keep = (d > c) & (d <= r)
    return ii[keep].astype(np.int32), jj[keep].astype(np.int32)


def build_frame_graph(distance_matrix, num=16, thresh=24.0, r=2):
    """Training covisibility graph from a flow-distance matrix: the radius-r
    temporal edges, then the closest remaining pairs under thresh, greedily,
    until there are `num` edges."""
    d = np.array(distance_matrix, dtype=np.float64, copy=True)
    N = d.shape[0]
    count = 0
    graph = OrderedDict()
    for i in range(N):
        graph[i] = []
        d[i, i] = np.inf
        for j in range(i - r, i + r + 1):
            if 0 <= j < N and i != j:
                graph[i].append(j)
                d[i, j] = np.inf
                count += 1

    while count < num:
        ix = np.argmin(d)
        i, j = ix // N, ix % N
        if d[i, j] < thresh:
            graph[i].append(j)
            d[i, j] = np.inf
            count += 1
        else:
            break
    return graph
