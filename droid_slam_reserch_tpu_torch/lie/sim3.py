"""Sim3 as [t(3), q(4 xyzw), s(1)] 8-vectors on tensors (mirror of the JAX
package's lie/sim3.py).

Manifold dim 7, tangent order [tau, phi, sigma]; retraction is left
multiplication exp(xi) * X.  The exp's coefficients guard every branch's
arguments (the double ``where``) so that gradients stay finite at theta = 0
and sigma = 0.
"""
import torch

from .se3 import hat, homogeneous
from .so3 import _cross, quat_act, quat_inv, quat_mul, quat_to_matrix, so3_exp, so3_log


def sim3_identity(shape=(), dtype=torch.float32, device=None):
    """Identity 8-vector(s): [0,0,0, 0,0,0,1, 1]."""
    base = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1], dtype=dtype, device=device)
    return base.expand(tuple(shape) + (8,)).clone()


def sim3_mul(X, Y):
    t = X[..., :3] + X[..., 7:8] * quat_act(X[..., 3:7], Y[..., :3])
    q = quat_mul(X[..., 3:7], Y[..., 3:7])
    return torch.cat([t, q, X[..., 7:8] * Y[..., 7:8]], dim=-1)


def sim3_inv(X):
    qi = quat_inv(X[..., 3:7])
    si = 1.0 / X[..., 7:8]
    return torch.cat([-si * quat_act(qi, X[..., :3]), qi, si], dim=-1)


def sim3_act(X, P):
    """Act on homogeneous points [p, h]: Y = [s R p + h t, h]."""
    p, h = P[..., :3], P[..., 3:4]
    y = X[..., 7:8] * quat_act(X[..., 3:7], p) + h * X[..., :3]
    return torch.cat([y, h], dim=-1)


def _w_coeffs(sigma, theta_sq):
    """Coefficients (C, B, A) of W = C I + B hat + A hat^2 of the exp."""
    s = torch.exp(sigma)
    sig_small = sigma.abs() < 1e-5
    th_small = theta_sq < 1e-8
    sig = torch.where(sig_small, torch.ones_like(sigma), sigma)
    th = torch.sqrt(torch.where(th_small, torch.ones_like(theta_sq), theta_sq))
    denom = sig * sig + th * th

    # C = int_0^1 e^{sigma u} du
    C = torch.where(sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / sig)

    # B = (1/theta) int e^{sigma u} sin(u theta) du
    B_full = (s * (sig * torch.sin(th) - th * torch.cos(th)) + th) / (th * denom)
    B_th_small = torch.where(sig_small, 0.5 + sigma / 3.0, (s * (sig - 1.0) + 1.0) / (sig * sig))
    B_sig_small = ((1.0 - torch.cos(th)) / (th * th)
                   + sigma * ((torch.sin(th) - th * torch.cos(th)) / (th ** 3)))
    B = torch.where(th_small, B_th_small, torch.where(sig_small, B_sig_small, B_full))

    # A = (1/theta^2) (C - int e^{sigma u} cos(u theta) du)
    int_cos = (s * (sig * torch.cos(th) + th * torch.sin(th)) - sig) / denom
    A_full = (C - int_cos) / (th * th)
    A_th_small = torch.where(sig_small, 1.0 / 6.0 + sigma / 8.0,
                             0.5 * (s * (sig * sig - 2.0 * sig + 2.0) - 2.0) / (sig ** 3))
    A_sig_small = ((th - torch.sin(th)) / (th ** 3)
                   + sigma * ((2.0 - 2.0 * torch.cos(th) - th * torch.sin(th)) / (th ** 4)))
    A = torch.where(th_small, A_th_small, torch.where(sig_small, A_sig_small, A_full))
    return C, B, A


def _w_matrix(phi, sigma):
    C, B, A = _w_coeffs(sigma, torch.sum(phi * phi, dim=-1, keepdim=True))
    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return C[..., None] * eye + B[..., None] * K + A[..., None] * (K @ K)


def sim3_exp(xi):
    """Tangent [tau, phi, sigma] (..., 7) -> Sim3 8-vector."""
    tau, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    t = (_w_matrix(phi, sigma) @ tau[..., None])[..., 0]
    return torch.cat([t, so3_exp(phi), torch.exp(sigma)], dim=-1)


def sim3_log(X):
    """Sim3 8-vector -> tangent [tau, phi, sigma] (..., 7)."""
    phi = so3_log(X[..., 3:7])
    sigma = torch.log(X[..., 7:8])
    tau = torch.linalg.solve(_w_matrix(phi, sigma), X[..., :3, None])[..., 0]
    return torch.cat([tau, phi, sigma], dim=-1)


def sim3_retr(X, xi):
    return sim3_mul(sim3_exp(xi), X)


def sim3_adjT(X, a):
    """Dual adjoint applied to a (..., 7) row vector [a_tau, a_phi, a_sigma]:
    out_tau = s R^-1 a_tau, out_phi = R^-1 (a_phi - t x a_tau),
    out_sigma = a_sigma - t . a_tau."""
    qi = quat_inv(X[..., 3:7])
    t = X[..., :3]
    a_tau, a_phi, a_sig = a[..., :3], a[..., 3:6], a[..., 6:7]
    out_tau = X[..., 7:8] * quat_act(qi, a_tau)
    out_phi = quat_act(qi, a_phi - _cross(t, a_tau))
    out_sig = a_sig - torch.sum(t * a_tau, dim=-1, keepdim=True)
    return torch.cat([out_tau, out_phi, out_sig], dim=-1)


def sim3_matrix(X):
    """Sim3 8-vector -> homogeneous 4x4 matrix (sR | t)."""
    return homogeneous(X[..., 7:8, None] * quat_to_matrix(X[..., 3:7]), X[..., :3])
