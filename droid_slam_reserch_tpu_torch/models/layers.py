"""Shared layer helpers: the gradient clip, instance norm, convs.

Modules take and return NHWC tensors at their boundaries, as the JAX
package does; inside, ``x.permute(0, 3, 1, 2)`` gives the NCHW view that
``nn.Conv2d`` expects (a channels-last tensor, so no copy is made).
"""
import torch
from torch import nn


GRAD_CLIP = 0.01


class _GradientClip(torch.autograd.Function):
    """Identity forward; the backward zeroes gradient entries with
    |g| > 0.01 or NaN (upstream modules/clipping.py)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.where((g.abs() > GRAD_CLIP) | torch.isnan(g), torch.zeros_like(g), g)


class GradientClip(nn.Module):
    """The gradient clip at the update operator's three heads, as a module
    so ``nn.Sequential`` indices match the upstream checkpoint keys
    (``update.weight.2`` is the conv before it)."""

    def forward(self, x):
        if not (torch.is_grad_enabled() and x.requires_grad):
            return x
        return _GradientClip.apply(x)


def instance_norm(x, eps=1e-5):
    """InstanceNorm2d without affine parameters, NCHW: per-sample,
    per-channel normalisation over the spatial dims (biased variance).

    The statistics are taken in fp32 and cast to x's dtype, as jnp.mean and
    jnp.var do for bf16; the normalisation itself runs in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True).to(x.dtype)
    var = xf.var(dim=(2, 3), keepdim=True, unbiased=False).to(x.dtype)
    return (x - mean) * torch.rsqrt(var + eps)


def tconv(cin, cout, kernel=3, stride=1, padding=None):
    """Conv2d with torch's symmetric padding (kernel // 2 unless given)."""
    pad = kernel // 2 if padding is None else padding
    return nn.Conv2d(cin, cout, kernel, stride=stride, padding=pad)


def to_nchw(x):
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    return x.permute(0, 2, 3, 1)
