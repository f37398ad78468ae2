"""Quaternion Lie groups (SO3 / SE3) as plain functions on tensors.

Conventions match the JAX package exactly: xyzw quaternions, SE3 data
``[tx, ty, tz, qx, qy, qz, qw]``, tangent order ``[tau, phi]``, left
retraction ``retr(X, xi) = exp(xi) * X``.  Sim3 waits for a later slice.
"""
from .so3 import quat_act, quat_inv, quat_mul, quat_to_matrix, so3_exp, so3_log
from .se3 import (
    se3_act,
    se3_adjT,
    se3_exp,
    se3_identity,
    se3_inv,
    se3_log,
    se3_mul,
    se3_retr,
)

__all__ = [k for k in dir() if not k.startswith("_")]
