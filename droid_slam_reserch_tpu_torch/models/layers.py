"""Shared layer helpers: the gradient clip, instance norm, convs.

Modules take and return NHWC tensors at their boundaries, as the JAX
package does; inside, ``x.permute(0, 3, 1, 2)`` gives the NCHW view that
``nn.Conv2d`` expects (a channels-last tensor, so no copy is made).
"""
import torch
from torch import nn

from ..ops import cuda_conv
from ..utils import timing


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


class UpdateConv(nn.Conv2d):
    """The update operator's convolutions (``models/update.py``,
    ``models/gru.py``): an ``nn.Conv2d`` with the same parameters and
    ``state_dict`` keys, whose 3x3 calls that ``routes_to_kernel`` accepts go
    to ``ops.cuda_conv.conv3x3`` (the hand-written kernel on the card, its
    plain version on the CPU).  Every other call is ``F.conv2d`` (cuDNN on
    the card); those that are 3x3 are counted as ``conv3x3.cudnn``.  The
    kernel's weights are packed once per weight version (the tensor, its
    storage and its ``_version``) and kept here, outside the state_dict."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._packed = None

    def routes_to_kernel(self, x):
        """The routing rule, but for the device: a 4-D fp32 input and
        weight, a 3x3 kernel at stride 1, padding 1 (zeros), dilation 1,
        groups 1, C_in % 32 == 0 and C_out % 64 == 0, and no autograd graph
        being built (grad mode off, or nothing requires grad)."""
        w, b = self.weight, self.bias
        grads = x.requires_grad or w.requires_grad or (b is not None and b.requires_grad)
        return (x.dtype == torch.float32 and w.dtype == torch.float32 and x.dim() == 4
                and self.kernel_size == (3, 3) and self.stride == (1, 1)
                and self.padding == (1, 1) and self.dilation == (1, 1) and self.groups == 1
                and self.padding_mode == "zeros" and self.in_channels % 32 == 0
                and self.out_channels % 64 == 0 and not (torch.is_grad_enabled() and grads))

    def packed_weight(self):
        """``cuda_conv.pack_weight(self.weight)``, packed again only when the
        weight tensor, its storage or its version changes."""
        w = self.weight
        key = (w.data_ptr(), w._version, w.device)
        if self._packed is None or self._packed[0] is not w or self._packed[1] != key:
            self._packed = (w, key, cuda_conv.pack_weight(w))
        return self._packed[2]

    def forward(self, x):
        if self.routes_to_kernel(x):
            packed = self.packed_weight() if x.is_cuda else None
            return cuda_conv.conv3x3(x, self.weight, self.bias, packed)
        if self.kernel_size == (3, 3):
            timing.count("conv3x3.cudnn")
        return super().forward(x)


def uconv(cin, cout, kernel=3, padding=None):
    """``tconv`` for the update operator: an ``UpdateConv`` at stride 1."""
    pad = kernel // 2 if padding is None else padding
    return UpdateConv(cin, cout, kernel, padding=pad)


def to_nchw(x):
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    return x.permute(0, 2, 3, 1)
