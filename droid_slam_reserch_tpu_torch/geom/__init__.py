"""Projective geometry with analytic Jacobians, and covisibility graph helpers."""
from .projective import (
    MIN_DEPTH,
    actp,
    coords_grid,
    frame_distance,
    iproj,
    proj,
    projective_transform,
    relative_poses,
)
from .graph_utils import neighbourhood_graph

__all__ = [k for k in dir() if not k.startswith("_")]
