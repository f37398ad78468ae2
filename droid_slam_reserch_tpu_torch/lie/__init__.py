"""Quaternion Lie groups (SO3 / SE3 / Sim3) as plain functions on tensors.

Conventions match the JAX package exactly: xyzw quaternions, SE3 data
``[tx, ty, tz, qx, qy, qz, qw]``, Sim3 data ``[t, q, s]``, tangent order
``[tau, phi]`` (Sim3: ``[tau, phi, sigma]``), left retraction
``retr(X, xi) = exp(xi) * X``.
"""
from .so3 import (
    matrix_to_quat,
    quat_act,
    quat_inv,
    quat_mul,
    quat_normalize,
    quat_to_matrix,
    so3_exp,
    so3_log,
)
from .se3 import (
    se3_act,
    se3_act3,
    se3_adj,
    se3_adjT,
    se3_exp,
    se3_from_matrix,
    se3_identity,
    se3_inv,
    se3_log,
    se3_matrix,
    se3_mul,
    se3_retr,
)
from .sim3 import (
    sim3_act,
    sim3_adjT,
    sim3_exp,
    sim3_identity,
    sim3_inv,
    sim3_log,
    sim3_matrix,
    sim3_mul,
    sim3_retr,
)

__all__ = [k for k in dir() if not k.startswith("_")]
