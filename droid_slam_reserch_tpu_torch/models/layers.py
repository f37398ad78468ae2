"""Shared layer helpers: forward-only gradient clip, instance norm, convs.

Modules take and return NHWC tensors at their boundaries, as the JAX
package does; inside, ``x.permute(0, 3, 1, 2)`` gives the NCHW view that
``nn.Conv2d`` expects (a channels-last tensor, so no copy is made).
"""
import torch
from torch import nn


class GradientClip(nn.Module):
    """Identity in the forward pass (the port does not train yet).

    Kept as a module so ``nn.Sequential`` indices match the upstream
    checkpoint keys (``update.weight.2`` is the conv before it).
    """

    def forward(self, x):
        return x


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
