"""Covisibility graph helpers (mirror of geom/graph_utils.py)."""
import numpy as np


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
