"""SO3 as xyzw quaternions on tensors (mirror of the JAX package's lie/so3.py).

Hamilton product, xyzw layout; every function broadcasts over leading dims.
"""
import torch


def quat_mul(q, p):
    """Hamilton product q*p, xyzw layout."""
    qx, qy, qz, qw = q.unbind(-1)
    px, py, pz, pw = p.unbind(-1)
    return torch.stack(
        [
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py + qy * pw + qz * px - qx * pz,
            qw * pz + qz * pw + qx * py - qy * px,
            qw * pw - qx * px - qy * py - qz * pz,
        ],
        dim=-1,
    )


def quat_inv(q):
    """Conjugate (unit quaternions)."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_act(q, X):
    """Rotate 3-vector X by unit quaternion q."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    uv = 2.0 * _cross(qv, X)
    return X + qw * uv + _cross(qv, uv)


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)


def so3_exp(phi):
    """Axis-angle (..., 3) -> quaternion xyzw, with the reference's Taylor cutoffs."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta_p4 = theta_sq * theta_sq
    small = theta_sq < 1e-8
    imag_t = 0.5 - (1.0 / 48.0) * theta_sq + (1.0 / 3840.0) * theta_p4
    real_t = 1.0 - (1.0 / 8.0) * theta_sq + (1.0 / 384.0) * theta_p4
    theta_safe = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    imag_f = torch.sin(0.5 * theta_safe) / theta_safe
    real_f = torch.cos(0.5 * theta_safe)
    imag = torch.where(small, imag_t, imag_f)
    real = torch.where(small, real_t, real_f)
    return torch.cat([imag * phi, real], dim=-1)


def so3_log(q):
    """Quaternion xyzw -> axis-angle (..., 3), shortest path."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    sign = torch.where(qw < 0, -1.0, 1.0)
    qv = qv * sign
    qw = qw * sign
    nv_sq = torch.sum(qv * qv, dim=-1, keepdim=True)
    small = nv_sq < 1e-14
    nv_safe = torch.sqrt(torch.where(small, torch.ones_like(nv_sq), nv_sq))
    theta = 2.0 * torch.atan2(nv_safe, qw.clamp(-1.0, 1.0))
    scale_f = theta / nv_safe
    scale_t = 2.0 / qw.clamp_min(1e-12) * (1.0 - nv_sq / (3.0 * qw * qw))
    return torch.where(small, scale_t, scale_f) * qv


def quat_to_matrix(q):
    """Unit quaternion xyzw -> 3x3 rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(R):
    """3x3 rotation matrix -> quaternion xyzw (Shepperd's method, branchless:
    the case with the largest of trace, m00, m11, m22)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cases = torch.stack([
        torch.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], dim=-1),
        torch.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], dim=-1),
        torch.stack([m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21, m02 - m20], dim=-1),
        torch.stack([m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11, m10 - m01], dim=-1),
    ], dim=-2)
    idx = torch.stack([tr, m00, m11, m22], dim=-1).argmax(dim=-1)
    q = torch.gather(cases, -2, idx[..., None, None].expand(idx.shape + (1, 4))).squeeze(-2)
    return quat_normalize(q)
