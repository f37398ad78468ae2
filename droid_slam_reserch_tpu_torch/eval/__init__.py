"""Trajectory metrics (ATE/RPE with Umeyama alignment, KITTI drift, the
TartanAir score) and the oracle frontend gate."""
from .metrics import (
    ate_rmse,
    evaluate_ate,
    evaluate_tartanair,
    kitti_metrics,
    rpe,
    tum_trajectory_to_matrix,
    umeyama_alignment,
)

__all__ = [k for k in dir() if not k.startswith("_")]
