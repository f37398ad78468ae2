"""Visualization (mirror of the JAX package's viz/): point-cloud
backprojection, the multi-view depth-consistency filter, PLY export, and
the live viewer that streams a PLY while tracking runs.

Reference droid_slam/visualization.py and the iproj / depth_filter CUDA
kernels (src/droid_kernels.cu:661-850).  The geometry is plain torch on the
caller's device: the JAX package computes it in jnp with no Pallas kernel.
"""
from .live import LiveViewer, try_open3d_viewer
from .pointcloud import backproject_points, depth_filter, export_ply, reconstruction_pointcloud

__all__ = [k for k in dir() if not k.startswith("_")]
