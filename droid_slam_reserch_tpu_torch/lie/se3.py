"""SE3 as [t(3), q(4 xyzw)] 7-vectors on tensors (mirror of lie/se3.py).

Tangent order [tau, phi]; retraction is left multiplication exp(xi) * X.
"""
import torch

from .so3 import (_cross, matrix_to_quat, quat_act, quat_inv, quat_mul, quat_to_matrix, so3_exp,
                  so3_log)


def se3_identity(shape=(), dtype=torch.float32, device=None):
    """Identity 7-vector(s): [0,0,0, 0,0,0,1]."""
    base = torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=dtype, device=device)
    return base.expand(tuple(shape) + (7,)).clone()


def se3_mul(X, Y):
    """Group product X*Y."""
    t = X[..., :3] + quat_act(X[..., 3:7], Y[..., :3])
    q = quat_mul(X[..., 3:7], Y[..., 3:7])
    return torch.cat([t, q], dim=-1)


def se3_inv(X):
    qi = quat_inv(X[..., 3:7])
    ti = -quat_act(qi, X[..., :3])
    return torch.cat([ti, qi], dim=-1)


def se3_act(X, P):
    """Act on homogeneous points P=[x,y,z,h]: Y = [R p + h t, h]."""
    p, h = P[..., :3], P[..., 3:4]
    y = quat_act(X[..., 3:7], p) + h * X[..., :3]
    return torch.cat([y, h], dim=-1)


def se3_act3(X, p):
    """Act on 3D points: R p + t."""
    return quat_act(X[..., 3:7], p) + X[..., :3]


def hat(phi):
    """Skew matrix [..., 3, 3] of (..., 3)."""
    x, y, z = phi.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).reshape(phi.shape[:-1] + (3, 3))


def _v_coeffs(theta_sq):
    """a=(1-cos)/th^2, b=(th-sin)/th^3 with Taylor fallbacks."""
    small = theta_sq < 1e-8
    th = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    a_f = (1.0 - torch.cos(th)) / (th * th)
    b_f = (th - torch.sin(th)) / (th ** 3)
    a_t = 0.5 - theta_sq / 24.0 + theta_sq * theta_sq / 720.0
    b_t = 1.0 / 6.0 - theta_sq / 120.0 + theta_sq * theta_sq / 5040.0
    return torch.where(small, a_t, a_f), torch.where(small, b_t, b_f)


def se3_exp(xi):
    """Tangent [tau, phi] (..., 6) -> SE3 7-vector."""
    tau, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp(phi)
    a, b = _v_coeffs(torch.sum(phi * phi, dim=-1, keepdim=True))
    c1 = _cross(phi, tau)
    c2 = _cross(phi, c1)
    return torch.cat([tau + a * c1 + b * c2, q], dim=-1)


def se3_log(X):
    """SE3 7-vector -> tangent [tau, phi] (..., 6)."""
    phi = so3_log(X[..., 3:7])
    t = X[..., :3]
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta_sq < 1e-8
    half = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq)) / 2.0
    c_f = (1.0 - half * torch.cos(half) / torch.sin(half).clamp_min(1e-12)) / theta_sq.clamp_min(1e-12)
    c_t = 1.0 / 12.0 + theta_sq / 720.0
    c = torch.where(small, c_t, c_f)
    c1 = _cross(phi, t)
    c2 = _cross(phi, c1)
    return torch.cat([t - 0.5 * c1 + c * c2, phi], dim=-1)


def se3_retr(X, xi):
    """Left retraction exp(xi) * X."""
    return se3_mul(se3_exp(xi), X)


def se3_adjT(X, a):
    """Dual adjoint Adj_X^T applied to a (..., 6) row vector."""
    qi = quat_inv(X[..., 3:7])
    u = _cross(a[..., :3], X[..., :3])
    lin = quat_act(qi, a[..., :3])
    ang = quat_act(qi, a[..., 3:6]) + quat_act(qi, u)
    return torch.cat([lin, ang], dim=-1)


def se3_adj(X, a):
    """Adjoint Adj_X applied to a (..., 6) tangent vector [tau, phi]."""
    q, t = X[..., 3:7], X[..., :3]
    phi2 = quat_act(q, a[..., 3:6])
    tau2 = quat_act(q, a[..., :3]) + _cross(t, phi2)
    return torch.cat([tau2, phi2], dim=-1)


def homogeneous(R, t):
    """[..., 3, 3] block (rotation, or scaled rotation) and [..., 3]
    translation -> [..., 4, 4]."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def se3_matrix(X):
    """SE3 7-vector -> homogeneous 4x4 matrix."""
    return homogeneous(quat_to_matrix(X[..., 3:7]), X[..., :3])


def se3_from_matrix(T):
    """4x4 homogeneous matrix -> SE3 7-vector."""
    return torch.cat([T[..., :3, 3], matrix_to_quat(T[..., :3, :3])], dim=-1)
