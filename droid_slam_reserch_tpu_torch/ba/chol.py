"""Damped, failure-tolerant Cholesky solves for the training BA (mirror of
the JAX package's ba/chol.py).

A factorization that fails (a system that is not positive definite, or that
overflowed to NaN or inf) gives a zero solution and a zero gradient for its
batch item, as the upstream CUDA solver zeroes a failed solve.  The
backward is the upstream CholeskySolver's: dz = H^-1 g, dH = -x dz^T, db = dz.
"""
import torch


def _bad(x, info):
    """[B, 1, 1] mask of batch items whose factorization failed or whose x is
    not finite."""
    return (info != 0)[..., None, None] | (~torch.isfinite(x)).any(dim=(-2, -1), keepdim=True)


class CholeskySolveSafe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, H, b):
        U, info = torch.linalg.cholesky_ex(H)
        xs = torch.cholesky_solve(b, U)
        bad = _bad(xs, info)
        xs = torch.where(bad, torch.zeros_like(xs), xs)
        ctx.save_for_backward(U, xs, bad)
        return xs

    @staticmethod
    def backward(ctx, grad_x):
        U, xs, bad = ctx.saved_tensors
        dz = torch.cholesky_solve(grad_x, U)
        dz = torch.where(bad | ~torch.isfinite(dz), torch.zeros_like(dz), dz)
        return -torch.matmul(xs, dz.transpose(-1, -2)), dz


def cholesky_solve_safe(H, b):
    """Solve H x = b for H [B, n, n], b [B, n, k]; zeros where H cannot be
    factored."""
    return CholeskySolveSafe.apply(H, b)


def _damp(H, ep, lm):
    """H + (ep + lm * H) * I: the diagonal raised by ep plus lm times itself."""
    return H + (ep + lm * H) * torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)


def block_solve(H, b, ep=0.1, lm=1e-4):
    """Solve block normal equations: H [B, N, N, D, D], b [B, N, D] -> x [B, N, D]."""
    B, N, _, D, _ = H.shape
    H = H.permute(0, 1, 3, 2, 4).reshape(B, N * D, N * D)
    x = cholesky_solve_safe(_damp(H, ep, lm), b.reshape(B, N * D, 1))
    return x.reshape(B, N, D)


def schur_solve(H, E, C, v, w, ep=0.1, lm=1e-4):
    """Solve by the Schur complement over the depth variables.

    H [B, P, P, D, D], E [B, P, M, D, HW], C [B, M, HW] (the damped depth
    diagonal), v [B, P, D], w [B, M, HW] -> (dx [B, P, D], dz [B, M, HW]).
    A non-finite dz is zeroed per batch item, so a degenerate system skips
    the whole update.
    """
    B, P, M, D, HW = E.shape
    H = _damp(H.permute(0, 1, 3, 2, 4).reshape(B, P * D, P * D), ep, lm)
    E = E.permute(0, 1, 3, 2, 4).reshape(B, P * D, M * HW)
    Q = (1.0 / C).reshape(B, M * HW, 1)
    v = v.reshape(B, P * D, 1)
    w = w.reshape(B, M * HW, 1)

    Et = E.transpose(1, 2)
    S = H - torch.matmul(E, Q * Et)
    rhs = v - torch.matmul(E, Q * w)
    dx = cholesky_solve_safe(S, rhs)
    dz = Q * (w - torch.matmul(Et, dx))
    bad = (~torch.isfinite(dz)).any(dim=(-2, -1), keepdim=True)
    dz = torch.where(bad, torch.zeros_like(dz), dz)
    return dx.reshape(B, P, D), dz.reshape(B, M, HW)
