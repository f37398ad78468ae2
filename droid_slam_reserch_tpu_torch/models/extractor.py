"""Feature / context encoder (mirror of models/extractor.py).

BasicEncoder: conv7x7/s2 -> 3 residual stages (dims 32/64/128, strides
1/2/2) -> 1x1 output conv; overall stride 8.  fnet uses instance norm
without affine parameters, cnet no norm, so neither has norm parameters.
Parameter names are the upstream checkpoint's (``layer1.0.conv1``, ...).
"""
import torch.nn.functional as F
from torch import nn

from .layers import instance_norm, tconv, to_nchw, to_nhwc

DIM = 32


def _norm(x, norm_fn):
    if norm_fn == "instance":
        return instance_norm(x)
    if norm_fn == "none":
        return x
    raise ValueError(f"unsupported norm_fn: {norm_fn}")


class ResidualBlock(nn.Module):
    """Two 3x3 convs + skip, NCHW inside the encoder."""

    def __init__(self, cin, planes, norm_fn="instance", stride=1):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = tconv(cin, planes, 3, stride)
        self.conv2 = tconv(planes, planes, 3, 1)
        self.downsample = (
            nn.Sequential(tconv(cin, planes, 1, stride, padding=0)) if stride != 1 else None
        )

    def forward(self, x):
        y = F.relu(_norm(self.conv1(x), self.norm_fn))
        y = F.relu(_norm(self.conv2(y), self.norm_fn))
        if self.downsample is not None:
            x = _norm(self.downsample(x), self.norm_fn)
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck + skip, NCHW (the JAX package's
    BottleneckBlock; upstream extractor.py:59-114).  No encoder of DroidNet
    uses it; its parameters take params_from_jax's names (``conv1``,
    ``conv2``, ``conv3``, ``downsample.0``)."""

    def __init__(self, cin, planes, norm_fn="instance", stride=1):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = tconv(cin, planes // 4, 1, 1, padding=0)
        self.conv2 = tconv(planes // 4, planes // 4, 3, stride)
        self.conv3 = tconv(planes // 4, planes, 1, 1, padding=0)
        self.downsample = (
            nn.Sequential(tconv(cin, planes, 1, stride, padding=0)) if stride != 1 else None
        )

    def forward(self, x):
        y = F.relu(_norm(self.conv1(x), self.norm_fn))
        y = F.relu(_norm(self.conv2(y), self.norm_fn))
        y = F.relu(_norm(self.conv3(y), self.norm_fn))
        if self.downsample is not None:
            x = _norm(self.downsample(x), self.norm_fn)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """Stride-8 residual encoder: [B, H, W, 3] -> [B, H/8, W/8, output_dim]."""

    def __init__(self, output_dim=128, norm_fn="instance"):
        super().__init__()
        self.norm_fn = norm_fn
        self.conv1 = tconv(3, DIM, 7, 2, padding=3)
        cin = DIM
        for li, (dim, stride) in enumerate([(DIM, 1), (2 * DIM, 2), (4 * DIM, 2)], start=1):
            layer = nn.Sequential(
                ResidualBlock(cin, dim, norm_fn, stride),
                ResidualBlock(dim, dim, norm_fn, 1),
            )
            setattr(self, f"layer{li}", layer)
            cin = dim
        self.conv2 = tconv(cin, output_dim, 1, padding=0)

    def forward(self, x):
        x = F.relu(_norm(self.conv1(to_nchw(x)), self.norm_fn))
        x = self.layer3(self.layer2(self.layer1(x)))
        return to_nhwc(self.conv2(x))
