"""Dataset streams of the evaluation commands (mirror of the JAX package's
data/ streams), on ``imageio``, the port's PNG decoder, resize and remap.

Streams yield numpy tuples ``(t, image, intrinsics)`` or ``(t, image, depth,
intrinsics)`` where image is [H, W, 3] uint8 BGR (or [2, H, W, 3] stereo)
and intrinsics is [4] (fx, fy, cx, cy) at stream resolution.  The training
datasets (TartanAir on RGBDDataset, with RGBDAugmentor) yield numpy
(images, poses, disps, intrinsics) walks.
"""
from .eth3d import eth3d_stream, eth3d_timestamps
from .euroc import EUROC_INTRINSICS, euroc_stream, euroc_timestamps
from .imageio import imread, init_undistort_rectify_map, remap, resize, undistort
from .streams import generic_image_stream, resize_to_area
from .tartan import TARTAN_TEST_SPLIT, TartanAir, tartan_stream
from .tum import tum_stream, tum_timestamps
from .augmentation import RGBDAugmentor
from .base import RGBDDataset
from .factory import ConcatDataset, dataset_factory
from .rgbd_utils import all_pairs_distance_matrix, compute_distance_matrix_flow, loadtum

__all__ = [k for k in dir() if not k.startswith("_")]
