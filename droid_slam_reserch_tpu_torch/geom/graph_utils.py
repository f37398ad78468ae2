"""Covisibility graph helpers (mirror of geom/graph_utils.py)."""
import numpy as np


def neighbourhood_graph(n, r):
    """All ordered pairs with 1 <= |i-j| <= r."""
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    d = np.abs(ii - jj)
    keep = (d >= 1) & (d <= r)
    return ii[keep].astype(np.int32), jj[keep].astype(np.int32)
