"""Multisession map fusion (mirror of the JAX package's multisession/; the
fork's core contribution).

Stages (reference Euroc_Multisession_Stereo/ + droid_slam/loop_detect.py):
1. per-session stereo SLAM -> session checkpoint (keyframes + caches)
2. SE3 map-to-map alignment via seeded "loop" replay sessions + IQR-filtered
   mean transform, then joint backend over the concatenated pair
3. global fusion: concatenate all transformed maps (subsampled) + global BA
4. evaluation: inject fused keyframes per sequence, fill non-keyframe poses,
   concatenated ATE
"""
from .alignment import (
    compute_filtered_mean,
    estimate_alignment,
    normalize_transform,
    remove_outlier_rows,
    transform_poses,
)
from .group_sequence import parse_group_sequence
from .pipeline import (
    align_pair,
    evaluate_fused_map,
    extract_images_by_timestamp,
    fuse_maps,
    joint_backend,
    run_loop_session,
)

__all__ = [k for k in dir() if not k.startswith("_")]
