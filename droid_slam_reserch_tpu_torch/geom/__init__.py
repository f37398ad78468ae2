"""Projective geometry with analytic Jacobians, covisibility graph helpers
and the training losses."""
from .projective import (
    MIN_DEPTH,
    actp,
    coords_grid,
    frame_distance,
    induced_flow,
    iproj,
    proj,
    projective_transform,
    projmap,
    relative_poses,
)
from .graph_utils import build_frame_graph, graph_to_edge_list, keyframe_indicies, neighbourhood_graph
from . import losses

__all__ = [k for k in dir() if not k.startswith("_")]
