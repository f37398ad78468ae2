"""SE3 as [t(3), q(4 xyzw)] 7-vectors: the Lie-group algebra DROID-SLAM's
geometry needs, in plain PyTorch.

A frozen copy of the plain functions of the port's ``lie/so3.py`` and
``lie/se3.py`` (Hamilton product, tangent order [tau, phi], left
retraction exp(xi) * X), kept here so that the reference depends on no
module of the program.
"""
import torch


def quat_mul(q, p):
    qx, qy, qz, qw = q.unbind(-1)
    px, py, pz, pw = p.unbind(-1)
    return torch.stack([
        qw * px + qx * pw + qy * pz - qz * py,
        qw * py + qy * pw + qz * px - qx * pz,
        qw * pz + qz * pw + qx * py - qy * px,
        qw * pw - qx * px - qy * py - qz * pz,
    ], dim=-1)


def quat_inv(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_act(q, X):
    qv, qw = q[..., :3], q[..., 3:4]
    uv = 2.0 * cross(qv, X)
    return X + qw * uv + cross(qv, uv)


def so3_exp(phi):
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta_p4 = theta_sq * theta_sq
    small = theta_sq < 1e-8
    imag_t = 0.5 - (1.0 / 48.0) * theta_sq + (1.0 / 3840.0) * theta_p4
    real_t = 1.0 - (1.0 / 8.0) * theta_sq + (1.0 / 384.0) * theta_p4
    th = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    imag = torch.where(small, imag_t, torch.sin(0.5 * th) / th)
    real = torch.where(small, real_t, torch.cos(0.5 * th))
    return torch.cat([imag * phi, real], dim=-1)


def so3_log(q):
    sign = torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    qv, qw = q[..., :3] * sign, q[..., 3:4] * sign
    nv_sq = torch.sum(qv * qv, dim=-1, keepdim=True)
    small = nv_sq < 1e-14
    nv = torch.sqrt(torch.where(small, torch.ones_like(nv_sq), nv_sq))
    scale_f = 2.0 * torch.atan2(nv, qw.clamp(-1.0, 1.0)) / nv
    scale_t = 2.0 / qw.clamp_min(1e-12) * (1.0 - nv_sq / (3.0 * qw * qw))
    return torch.where(small, scale_t, scale_f) * qv


def se3_identity(shape=(), device=None):
    base = torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=torch.float32, device=device)
    return base.expand(tuple(shape) + (7,)).clone()


def se3_mul(X, Y):
    t = X[..., :3] + quat_act(X[..., 3:7], Y[..., :3])
    return torch.cat([t, quat_mul(X[..., 3:7], Y[..., 3:7])], dim=-1)


def se3_inv(X):
    qi = quat_inv(X[..., 3:7])
    return torch.cat([-quat_act(qi, X[..., :3]), qi], dim=-1)


def se3_act(X, P):
    """Act on homogeneous points [x, y, z, h]: [R p + h t, h]."""
    p, h = P[..., :3], P[..., 3:4]
    return torch.cat([quat_act(X[..., 3:7], p) + h * X[..., :3], h], dim=-1)


def _v_coeffs(theta_sq):
    small = theta_sq < 1e-8
    th = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    a_f = (1.0 - torch.cos(th)) / (th * th)
    b_f = (th - torch.sin(th)) / (th ** 3)
    a_t = 0.5 - theta_sq / 24.0 + theta_sq * theta_sq / 720.0
    b_t = 1.0 / 6.0 - theta_sq / 120.0 + theta_sq * theta_sq / 5040.0
    return torch.where(small, a_t, a_f), torch.where(small, b_t, b_f)


def se3_exp(xi):
    tau, phi = xi[..., :3], xi[..., 3:6]
    a, b = _v_coeffs(torch.sum(phi * phi, dim=-1, keepdim=True))
    c1 = cross(phi, tau)
    c2 = cross(phi, c1)
    return torch.cat([tau + a * c1 + b * c2, so3_exp(phi)], dim=-1)


def se3_log(X):
    phi = so3_log(X[..., 3:7])
    t = X[..., :3]
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta_sq < 1e-8
    half = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq)) / 2.0
    c_f = ((1.0 - half * torch.cos(half) / torch.sin(half).clamp_min(1e-12))
           / theta_sq.clamp_min(1e-12))
    c = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0, c_f)
    c1 = cross(phi, t)
    return torch.cat([t - 0.5 * c1 + c * cross(phi, c1), phi], dim=-1)


def se3_retr(X, xi):
    return se3_mul(se3_exp(xi), X)


def se3_adjT(X, a):
    qi = quat_inv(X[..., 3:7])
    u = cross(a[..., :3], X[..., :3])
    return torch.cat([quat_act(qi, a[..., :3]),
                      quat_act(qi, a[..., 3:6]) + quat_act(qi, u)], dim=-1)
